"""The port's traced dry run against real CPU runs of the same programs,
its CLI, and the kernel wrappers' fake path.

- Reduced fp32 configs, one arch per family (dense, MoE, whisper, zamba2,
  rwkv6), prefill, decode and train (``build_program``'s programs):
  on a 1 x 1 fake mesh the dry run's ``cost.flops`` equals the real
  one-rank CPU program's (a gloo world of one): ``FlopCounterMode``
  outside the kernel wrappers, plus ``ops.kernel_cost`` for each wrapper
  call (the plain versions' own matmuls, a causal mask's wasted half
  among them, are not the kernels' work); on a (2, 2) fake mesh its
  collective tally (calls and moved bytes by kind and axis,
  ``distributed.sharding.COLLECTIVES``) and its kernel calls equal rank
  0's of a real 4-rank gloo CPU run.  The real runs place seeded values
  where the example arguments place meta blocks (``sharding.place_with``)
  and count each wrapper's calls; the counts do not depend on values.
- rwkv6's scaled loop (two trips run, their cost standing for the rest)
  against the full loop under the same dry run: flops and memory equal,
  bytes within 0.1% (prefill) and 6% (train).
- The CLI: the reference's file names, keys and console line,
  ``--skip-existing``, ``--dump-hlo`` refused, a skipped cell's reason.
- The wrappers' fake path: fake operands give fake outputs of the
  kernels' shapes and dtypes, counted in ``FAKE_LAUNCHES`` only; a real
  CPU tensor takes the plain version; a meta operand falls to the launch
  and is refused there, as before.

Subprocesses run together, each with a 240 s timeout.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import embedding_bag as eb_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import flash_decode as fd_mod
from repro_torch.kernels import ops

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
FAMILY_ARCHS = ["smollm-135m", "qwen2-moe-a2.7b", "whisper-large-v3",
                "zamba2-7b", "rwkv6-3b"]
SHAPES = [("prefill", 32, 8, "prefill"), ("decode", 32, 8, "decode"),
          ("train", 32, 8, "train")]

COMMON = r"""
import json, os, sys
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode
from torch.distributed.tensor import DTensor
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch.steps import build_program
from repro_torch.models.params import tree_map
ARCHS, SHAPES = json.loads(sys.argv[1]), json.loads(sys.argv[2])

def cfg_of(arch):
    return configs.get_reduced(arch).replace(dtype="float32",
                                             param_dtype="float32")
"""

REAL = COMMON + r"""
rank, world, d = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, f"store{world}"), rank=rank, world_size=world)
from torch.distributed.device_mesh import init_device_mesh
mesh = init_device_mesh("cpu", (1, 1) if world == 1 else (2, 2),
                        mesh_dim_names=("data", "model"))
CALLS, KFLOPS = {}, [0]

def counted(name, cost_of):
    orig = getattr(ops, name)
    def run(*a, **k):
        with _disable_current_modes():
            out = orig(*a, **k)
        CALLS[name] = CALLS.get(name, 0) + 1
        KFLOPS[0] += cost_of(*a, **k)
        return out
    setattr(ops, name, run)

counted("flash_attention", lambda q, k, v, causal=True, **kw:
        ops.kernel_cost("flash_attention", q, k, causal=causal)[0])
counted("flash_decode_partial", lambda q, kc, vc, pos, **kw:
        ops.kernel_cost("flash_decode_partial", q, kc)[0])
for bag in ("embedding_bag_fused_flat", "embedding_bag_nmp_flat"):
    counted(bag, lambda t, off, idx, _b=bag: ops.kernel_cost(_b, t, idx)[0])
counted("embedding_bag", lambda t, idx: ops.kernel_cost(
    "embedding_bag", t, idx)[0])

def real(x, vocab, pos, gen):
    # a whole seeded tensor where the example argument has a meta block
    if not isinstance(x, DTensor):
        return x
    if x.dtype.is_floating_point:
        whole = torch.randn(x.shape, generator=gen, dtype=x.dtype) * 0.02
    else:
        whole = torch.randint(0, vocab, x.shape, generator=gen,
                              dtype=x.dtype) if x.dim() else torch.full(
                                  (), pos, dtype=x.dtype)
    return shd.place_with(whole, x.placements, mesh)

out = {}
for arch in ARCHS:
    cfg = cfg_of(arch)
    for name, seq, batch, kind in SHAPES:
        sh = ShapeConfig(name, seq, batch, kind)
        fn, args, _ = build_program(cfg, sh, mesh)
        gen = torch.Generator().manual_seed(0)
        args = tuple(tree_map(lambda x: real(x, cfg.vocab_size, seq // 2, gen),
                              a) for a in args)
        shd.reset_collectives()
        CALLS.clear()
        KFLOPS[0] = 0
        fc = FlopCounterMode(display=False)
        with fc:
            fn(*args)
        out[f"{arch}|{name}"] = {
            "flops": fc.get_total_flops() + KFLOPS[0],
            "collectives": {k: {a: list(v) for a, v in axes.items()}
                            for k, axes in shd.COLLECTIVES.items()},
            "kernels": dict(CALLS)}
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""

FAKE = COMMON + r"""
from repro_torch.launch import dryrun
MESHES = json.loads(sys.argv[3])
out = {}
for arch in ARCHS:
    cfg = cfg_of(arch)
    for name, seq, batch, kind in SHAPES:
        sh = ShapeConfig(name, seq, batch, kind)
        for mesh in MESHES:
            rec = dryrun.run_cell(arch, name, False, mesh_shape=mesh,
                                  shape=sh, cfg=cfg)
            col = {k: {a: [v["calls"], v["bytes"]] for a, v in axes.items()}
                   for k, axes in rec["collectives"]["by_axis"].items()}
            out[f"{arch}|{name}|{mesh[0]}x{mesh[1]}"] = {
                "flops": rec["cost"]["flops"], "collectives": col,
                "kernels": rec["kernels"]}
# rwkv6's scaled loop against the full one
cfg = cfg_of("rwkv6-3b")
for kind in ("prefill", "train") if sys.argv[4] == "scan" else ():
    sh = ShapeConfig(kind, 64, 8, kind)
    for scaled in (False, True):
        rec = dryrun.run_cell("rwkv6-3b", kind, False, mesh_shape=(2, 2),
                              shape=sh, cfg=cfg, scale_loops=scaled)
        out[f"scan|{kind}|{scaled}"] = [
            rec["cost"]["flops"], rec["cost"]["bytes accessed"],
            rec["memory"]["temp_bytes"], rec.get("loop_scaled")]
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_trace")
    args = [json.dumps(FAMILY_ARCHS), json.dumps(SHAPES)]
    # the fake runs in two processes: the 1 x 1 mesh; the (2, 2) mesh and
    # the scaled loop
    cmds = [[sys.executable, "-c", FAKE, *args, "[[1, 1]]", ""],
            [sys.executable, "-c", FAKE, *args, "[[2, 2]]", "scan"],
            [sys.executable, "-c", REAL, *args, "0", "1", str(d)]]
    cmds += [[sys.executable, "-c", REAL, *args, str(r), "4", str(d)]
             for r in range(4)]
    procs = [subprocess.Popen(c, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, err[-3000:]
        outs.append(out.strip().splitlines()[-1] if out.strip() else "")
    fake = dict(json.loads(outs[0]), **json.loads(outs[1]))
    one, four = json.loads(outs[2]), json.loads(outs[3])
    return fake, one, four


CELLS = [(a, s[0]) for a in FAMILY_ARCHS for s in SHAPES]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_flops_equal_one_rank_cpu_run(runs, arch, kind):
    fake, one, _ = runs
    assert fake[f"{arch}|{kind}|1x1"]["flops"] == one[f"{arch}|{kind}"][
        "flops"] > 0


@pytest.mark.parametrize("arch,kind", CELLS)
def test_collectives_and_kernels_equal_gloo_run(runs, arch, kind):
    fake, _, four = runs
    got, want = fake[f"{arch}|{kind}|2x2"], four[f"{arch}|{kind}"]
    assert got["collectives"] == want["collectives"]
    assert got["kernels"] == want["kernels"]
    assert sum(c[0] for axes in got["collectives"].values()
               for c in axes.values()) > 0


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_rwkv6_scaled_loop_matches_full(runs, kind):
    fake = runs[0]
    full, scaled = fake[f"scan|{kind}|False"], fake[f"scan|{kind}|True"]
    assert full[3] is None and scaled[3] == {
        "loop": "models.rwkv6.wkv_scan", "trips": 64}
    assert scaled[0] == full[0]                   # flops
    assert scaled[2] == full[2]                   # temp bytes
    tol = 1e-3 if kind == "prefill" else 0.06
    assert abs(scaled[1] / full[1] - 1) <= tol    # bytes accessed


# ------------------------------------------------------------------- CLI
LINE = re.compile(r"^\[dryrun\] smollm-135m\|decode_32k\|(single|multi): ok "
                  r"mem/device=\d+\.\d\dGiB flops=\S+$")
KEYS = {"arch", "shape", "mesh", "status", "devices", "memory", "cost",
        "collectives", "hlo_scaled", "no_counterpart", "kernels",
        "fake_device"}


def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv], cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)


def test_cli_records_and_skip_existing(tmp_path):
    out = tmp_path / "rec"
    proc = _cli("--arch", "smollm-135m", "--shape", "decode_32k", "--mesh",
                "both", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 2 and all(LINE.match(ln) for ln in lines)
    names = sorted(p.name for p in out.iterdir())
    assert names == ["smollm-135m__decode_32k__multi.json",
                     "smollm-135m__decode_32k__single.json"]
    for n, devices in zip(names, (512, 256)):
        rec = json.loads((out / n).read_text())
        assert set(rec) == KEYS and rec["devices"] == devices
        assert set(rec["memory"]) == {
            "argument_bytes", "output_bytes", "temp_bytes",
            "generated_code_bytes", "alias_bytes", "total_per_device_bytes"}
        m = rec["memory"]
        assert m["total_per_device_bytes"] == (
            m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
            - m["alias_bytes"])
        assert m["generated_code_bytes"] is None and rec["hlo_scaled"] is None
        assert {"generated_code_bytes", "hlo_scaled"} <= set(
            rec["no_counterpart"])
        assert m["alias_bytes"] > 0          # the cache, written in place
        assert rec["kernels"] == {"flash_decode_partial": 30}
        assert set(rec["collectives"]) >= {"all-reduce", "all-gather",
                                           "total", "counts"}
    again = _cli("--arch", "smollm-135m", "--shape", "decode_32k", "--mesh",
                 "both", "--out", str(out), "--skip-existing")
    assert again.returncode == 0
    assert again.stdout.splitlines() == [
        "[dryrun] smollm-135m|decode_32k|single: cached (ok)",
        "[dryrun] smollm-135m|decode_32k|multi: cached (ok)"]


def test_cli_skip_and_dump_hlo(tmp_path):
    proc = _cli("--arch", "llama3-8b", "--shape", "long_500k", "--out",
                str(tmp_path))
    assert proc.returncode == 0
    assert proc.stdout.strip() == (
        "[dryrun] llama3-8b|long_500k|single: skip (SKIP(full-attention): "
        "long_500k needs sub-quadratic attention)")
    rec = json.loads((tmp_path / "llama3-8b__long_500k__single.json")
                     .read_text())
    assert rec == {"arch": "llama3-8b", "shape": "long_500k",
                   "mesh": "single", "status": "skip",
                   "reason": "SKIP(full-attention): long_500k needs "
                             "sub-quadratic attention"}
    refused = _cli("--arch", "llama3-8b", "--dump-hlo", str(tmp_path / "h"))
    assert refused.returncode == 2
    assert "--dump-hlo has no counterpart" in refused.stderr


# ------------------------------------------------------------ fake path
def _operands(device, mode=None):
    def make():
        f = dict(device=device)
        return {
            "flash_attention": (torch.zeros(1, 4, 8, 16, **f),
                                torch.zeros(1, 2, 8, 16, **f),
                                torch.zeros(1, 2, 8, 16, **f)),
            "flash_decode_partial": (torch.zeros(2, 4, 16, **f),
                                     torch.zeros(2, 8, 2, 16, **f),
                                     torch.zeros(2, 8, 2, 16, **f),
                                     torch.tensor(3, dtype=torch.int32,
                                                  **f)),
            "embedding_bag": (torch.zeros(3, 5, 8, dtype=torch.bfloat16, **f),
                              torch.zeros(2, 3, 4, dtype=torch.int32, **f)),
            "embedding_bag_fused_flat": (
                torch.zeros(15, 8, **f), torch.tensor([0, 5, 10],
                                                      dtype=torch.int32, **f),
                torch.zeros(2, 3, 4, dtype=torch.int32, **f)),
        }
    if mode is None:
        return make()
    with mode:
        return make()


def test_fake_operands_take_the_fake_path():
    ops.reset_launches()
    mode = FakeTensorMode()
    args = _operands("cpu", mode)
    with mode:
        o = ops.flash_attention(*args["flash_attention"])
        parts = ops.flash_decode_partial(*args["flash_decode_partial"])
        bag = ops.embedding_bag(*args["embedding_bag"])
        flat = ops.embedding_bag_fused_flat(*args["embedding_bag_fused_flat"])
        nmp = ops.embedding_bag_nmp_flat(*args["embedding_bag_fused_flat"])
    assert (o.shape, o.dtype) == ((1, 4, 8, 16), torch.float32)
    assert [(p.shape, p.dtype) for p in parts] == [
        ((2, 4, 16), torch.float32), ((2, 4), torch.float32),
        ((2, 4), torch.float32)]
    assert (bag.shape, bag.dtype) == ((2, 3, 8), torch.bfloat16)
    assert (flat.shape, flat.dtype) == (nmp.shape, nmp.dtype) == (
        (2, 3, 8), torch.float32)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    # 4 B H D pairs: causal over S = T = 8 keeps 36 pairs
    assert ops.FAKE_COST["flash_attention"][0] == 4 * 1 * 4 * 16 * 36
    assert ops.FAKE_COST["flash_decode_partial"][0] == 4 * 2 * 4 * 16 * 8
    assert ops.FAKE_LAUNCHES == {k: 1 for k in ops.LAUNCHES}
    ops.LAUNCHES["flash_attention"] = 7        # a real run's count
    ops.reset_fake()
    assert ops.FAKE_LAUNCHES == {k: 0 for k in ops.LAUNCHES}
    assert ops.LAUNCHES["flash_attention"] == 7
    ops.FAKE_COST["flash_attention"] = [1, 1]
    ops.reset_launches()
    assert ops.FAKE_COST["flash_attention"] == [0, 0]


def test_real_cpu_operands_take_the_plain_version():
    ops.reset_launches()
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 8, 16, generator=gen)
    k = torch.randn(1, 2, 8, 16, generator=gen)
    v = torch.randn(1, 2, 8, 16, generator=gen)
    assert torch.equal(ops.flash_attention(q, k, v),
                       fa_mod.flash_attention_plain(q, k, v))
    qd = torch.randn(2, 4, 16, generator=gen)
    kc = torch.randn(2, 8, 2, 16, generator=gen)
    got = ops.flash_decode_partial(qd, kc, kc, 3)
    want = fd_mod.flash_decode_plain(qd, kc, kc, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    tables = torch.randn(3, 5, 8, generator=gen)
    idx = torch.randint(-1, 5, (2, 3, 4), generator=gen, dtype=torch.int32)
    assert torch.equal(ops.embedding_bag(tables, idx),
                       eb_mod.embedding_bag_stacked_plain(tables, idx))
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert all(v == 0 for v in ops.FAKE_LAUNCHES.values())


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode_partial",
                                  "embedding_bag", "embedding_bag_fused_flat"])
def test_meta_operands_fall_to_the_launch(name):
    """A meta tensor is no ``FakeTensor``: it passes the fake path by,
    and the launch refuses it, as on the parent."""
    ops.reset_launches()
    with pytest.raises(ValueError):
        getattr(ops, name)(*_operands("meta")[name])
    assert all(v == 0 for v in ops.FAKE_LAUNCHES.values())
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_dry_run_leaves_launches_untouched():
    """A dry run counts its kernel calls apart: ``ops.LAUNCHES`` keeps a
    real run's counts, and the fake world is torn down after."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    ops.reset_launches()
    ops.LAUNCHES["flash_decode_partial"] = 480
    before = dict(ops.LAUNCHES)
    cfg = configs.get_reduced("smollm-135m")
    rec = dryrun.run_cell("smollm-135m", "decode", False, mesh_shape=(1, 2),
                          shape=ShapeConfig("decode", 32, 2, "decode"),
                          cfg=cfg)
    assert ops.LAUNCHES == before
    assert rec["kernels"] == {"flash_decode_partial": cfg.num_layers}
    assert ops.FAKE_LAUNCHES["flash_decode_partial"] == cfg.num_layers
    assert not dist.is_initialized()
    ops.reset_launches()
