"""Guards on the port's boundary: it never imports JAX or the JAX
package, and its entry points never drop to the CPU on their own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import rm1, smollm_135m, whisper_large_v3
from repro_torch.data.queries import dlrm_request_stream
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.models.dlrm import DLRMModel
from repro_torch.models.transformer import DecoderLM, params_from_reference
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import (DLRMServingEngine, LMServingEngine,
                                        Request)
from repro_torch.serving.scenario import ScenarioSpec, run_scenario

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_never_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_load_no_jax_module():
    code = ("import sys\n"
            "import repro_torch.launch.serve, repro_torch.serving.cluster,"
            " repro_torch.serving.scenario, repro_torch.models.transformer,"
            " repro_torch.models.registry, repro_torch.models.moe,"
            " repro_torch.models.whisper, repro_torch.models.mamba2,"
            " repro_torch.models.rwkv6, repro_torch.core.sharding,"
            " repro_torch.core.allocator, repro_torch.core.tco,"
            " repro_torch.launch.train, repro_torch.train.train_loop,"
            " repro_torch.train.optimizer, repro_torch.train.checkpoint,"
            " repro_torch.distributed.sharding,"
            " repro_torch.distributed.elastic, repro_torch.launch.mesh,"
            " repro_torch.launch.steps\n"
            "bad = sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise(no_cuda):
    model = DLRMModel(rm1.REDUCED)
    params = model.init(0, device="cpu")
    spec = ScenarioSpec(name="guard")
    calls = [
        lambda: model.init(0),
        lambda: ClusterEngine(model, params),
        lambda: DLRMServingEngine(model, params),
        lambda: run_scenario(spec),
        lambda: run_scenario(spec, model=model, params=params),
        lambda: serve.main(["--cluster", "--requests", "2"]),
        lambda: serve.main(["--requests", "2"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_explicit_cpu_runs(no_cuda):
    model = DLRMModel(rm1.REDUCED)
    params = model.init(0, device="cpu")
    eng = DLRMServingEngine(model, params, batch_size=8, device="cpu")
    reqs = [Request(*t) for t in dlrm_request_stream(rm1.REDUCED, 3)]
    out = eng.serve(reqs)
    assert [r.rid for r in out] == [0, 1, 2]
    assert all(np.isfinite(r.outputs).all() for r in out)


def test_lm_entry_points_without_device_raise(no_cuda):
    model = DecoderLM(smollm_135m.REDUCED)
    params = model.init(0, device="cpu")
    whisper = registry.build(whisper_large_v3.REDUCED)
    calls = [
        lambda: model.init(0),
        lambda: whisper.init(0),
        lambda: LMServingEngine(model, params),
        lambda: params_from_reference({"embed": np.zeros((2, 2))}),
        lambda: serve.main(["--arch", "smollm-135m"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    eng = LMServingEngine(model, params, cache_len=24, device="cpu")
    out = eng.generate(np.zeros((1, 4), np.int32), steps=2)
    assert out.shape == (1, 2) and out.dtype == np.int32


def test_train_entry_points_without_device_raise(no_cuda):
    from repro_torch.configs import SHAPES
    from repro_torch.data.queries import ShardedLoader, lm_batch
    from repro_torch.launch import train
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import TrainLoopConfig, run_train_loop

    model = DecoderLM(smollm_135m.REDUCED)
    loader = ShardedLoader(lambda rng: lm_batch(256, 2, 8, rng))
    calls = [
        lambda: train.main(["--reduced", "--steps", "1"]),
        lambda: run_train_loop(model, OptConfig(), loader,
                               TrainLoopConfig(steps=1)),
        lambda: model.init_cache(SHAPES["decode_32k"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_mesh_entry_points_without_device_raise(no_cuda):
    from repro_torch.distributed.elastic import healthy_mesh
    from repro_torch.launch.mesh import make_host_mesh

    for call in (lambda: make_host_mesh(2),
                 lambda: healthy_mesh({"model": 2}, devices=[0, 1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
