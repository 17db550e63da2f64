"""The port's optimizers, checkpoints, train loop and training CLI
(``repro_torch.train``, ``repro_torch.launch.train``) on the CPU.

The first tests mirror ``tests/test_optimizer_checkpoint.py`` test for
test (``state_specs`` waits for the mesh).  Then the port is held
against the reference on the same numpy inputs:

- ``apply_updates`` over 3 steps of Adam (with and without int8
  compression: the reference keeps error-feedback state for Adam only),
  Adagrad and SGD, and ``global_norm`` and ``compress_int8``:
  fp32 within 1e-6 (absolute; the leaves are O(1)), bf16 parameters
  within one bf16 step of each element (their fp32 updates may round
  to neighbouring bf16 values);
- a checkpoint written by either package restores in the other, bitwise;
- ``run_train_loop`` with an injected fault on reduced fp32 smollm: the
  same logged steps, and losses within 1e-5 relative.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.queries import ShardedLoader as JLoader
from repro.data.queries import lm_batch as jlm_batch
from repro.models import registry as jregistry
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch import configs
from repro_torch.data.queries import ShardedLoader, lm_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import registry
from repro_torch.models.transformer import params_from_reference
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import TrainLoopConfig, run_train_loop


def quad_problem():
    target = torch.from_numpy(np.random.RandomState(0).randn(32).astype(
        np.float32))
    params = {"w": torch.zeros(32)}

    def grads_of(p):
        return {"w": 2 * (p["w"] - target)}

    def loss_fn(p):
        return float(torch.sum((p["w"] - target) ** 2))

    return params, grads_of, loss_fn, target


@pytest.mark.parametrize("kind", ["adam", "adagrad", "sgd"])
def test_optimizers_converge_quadratic(kind):
    params, grads_of, loss_fn, target = quad_problem()
    cfg = OptConfig(kind=kind, lr=0.1 if kind != "sgd" else 0.05,
                    grad_clip=1e9)
    state = opt_mod.init_state(cfg, params)
    for _ in range(300):
        params, state = opt_mod.apply_updates(cfg, params, grads_of(params),
                                              state)
    assert loss_fn(params) < 0.05 * float(torch.sum(target ** 2))


def test_grad_compression_error_feedback():
    """int8 compression with error feedback still converges."""
    params, grads_of, loss_fn, target = quad_problem()
    cfg = OptConfig(kind="adam", lr=0.1, compress_grads=True, grad_clip=1e9)
    state = opt_mod.init_state(cfg, params)
    for _ in range(400):
        params, state = opt_mod.apply_updates(cfg, params, grads_of(params),
                                              state)
    assert loss_fn(params) < 0.1 * float(torch.sum(target ** 2))


def test_compress_int8_bound():
    g = torch.from_numpy(np.random.RandomState(1).randn(1000).astype(
        np.float32))
    deq, err = opt_mod.compress_int8(g, torch.zeros_like(g))
    # quantization error bounded by one step of the scale
    scale = float(g.abs().max()) / 127.0
    assert float((g - deq).abs().max()) <= scale * 0.51 + 1e-6
    np.testing.assert_allclose(g.numpy(), (deq + err).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_grad_clip():
    params = {"w": torch.zeros(4)}
    cfg = OptConfig(kind="sgd", lr=1.0, grad_clip=1.0)
    state = opt_mod.init_state(cfg, params)
    p2, _ = opt_mod.apply_updates(cfg, params, {"w": torch.full((4,), 100.0)},
                                  state)
    assert float(torch.linalg.norm(p2["w"])) <= 1.0 + 1e-5


def test_checkpoint_roundtrip(tmp_path):
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "nested": {"b": torch.ones(4, dtype=torch.bfloat16)}}
    state = opt_mod.init_state(OptConfig(), params)
    d = str(tmp_path)
    ckpt.save(d, params, state, 42)
    assert ckpt.latest_step(d) == 42
    p2, s2, step = ckpt.try_restore(d, params, state)
    assert step == 42
    assert torch.equal(p2["a"], params["a"])
    assert p2["nested"]["b"].dtype == torch.bfloat16
    assert s2["step"].dtype == torch.int32 and s2["err"] is None


def test_checkpoint_latest_wins(tmp_path):
    params = {"a": torch.zeros(3)}
    state = opt_mod.init_state(OptConfig(), params)
    d = str(tmp_path)
    ckpt.save(d, params, state, 10)
    ckpt.save(d, {"a": torch.ones(3)}, state, 20)
    p2, _, step = ckpt.try_restore(d, params, state)
    assert step == 20
    assert torch.equal(p2["a"], torch.ones(3))


def _fault_at(step_to_fail):
    fired = {"n": 0}

    def hook(step):
        if step == step_to_fail and fired["n"] == 0:
            fired["n"] = 1
            raise RuntimeError("injected node failure")
    return hook, fired


def test_train_loop_fault_recovery(tmp_path):
    """Simulated node failure mid-training: the loop restores the
    checkpoint and completes (the CN-failure recovery path)."""
    cfg = configs.get_reduced("smollm-135m")
    model = registry.build(cfg)
    hook, fired = _fault_at(7)
    loop_cfg = TrainLoopConfig(steps=12, log_every=4, checkpoint_every=5,
                               checkpoint_dir=str(tmp_path))
    logs = []
    params, state, hist = run_train_loop(
        model, OptConfig(lr=1e-3),
        ShardedLoader(lambda rng: lm_batch(cfg.vocab_size, 2, 16, rng)),
        loop_cfg, fault_hook=hook, log_fn=logs.append, device="cpu")
    assert fired["n"] == 1
    assert ckpt.latest_step(str(tmp_path)) == 12
    assert any(line.startswith("[fault] step 7") for line in logs)
    assert [s for s, _ in hist] == [0, 4, 8]
    assert int(state["step"]) == 12


# ----------------------------------------------------- against the reference


SHAPES = {"b": (3, 5), "a": {"y": (7,), "x": (2, 2, 4)}}


def _np_tree(seed):
    rng = np.random.RandomState(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return rng.randn(*t).astype(np.float32)
    return walk(SHAPES)


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(tree).to(dtype)


def _assert_tree_close(t, j, dtype, path=""):
    if isinstance(t, dict):
        for k in t:
            _assert_tree_close(t[k], j[k], dtype, f"{path}/{k}")
        return
    want = np.asarray(j, np.float32)
    got = t.float().numpy()
    if dtype == "bfloat16":      # one bf16 step of each element
        atol = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -126)
        assert np.all(np.abs(got - want) <= atol), path
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                   err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,compress", [
    ("adam", False), ("adam", True), ("adagrad", False), ("sgd", False)])
def test_apply_updates_match_reference(kind, compress, dtype):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(kind=kind, lr=0.05, compress_grads=compress, grad_clip=2.0,
              weight_decay=0.01 if kind == "adam" else 0.0)
    jcfg, tcfg = jopt.OptConfig(**kw), OptConfig(**kw)
    p0 = _np_tree(0)
    jp, tp = _to_jax(p0, jd), _to_torch(p0, td)
    js, ts = jopt.init_state(jcfg, jp), opt_mod.init_state(tcfg, tp)
    for s in range(3):
        g = _np_tree(1 + s)
        jg, tg = _to_jax(g, jd), _to_torch(g, td)
        np.testing.assert_allclose(float(opt_mod.global_norm(tg)),
                                   float(jopt.global_norm(jg)), rtol=1e-6)
        jp, js = jopt.apply_updates(jcfg, jp, jg, js)
        tp, ts = opt_mod.apply_updates(tcfg, tp, tg, ts)
        _assert_tree_close(tp, jp, dtype)
        for key in ("m", "v", "err"):
            if js.get(key) is not None:
                _assert_tree_close(ts[key], js[key], "float32")
    assert int(ts["step"]) == int(js["step"]) == 3


def test_global_norm_sums_in_reference_order():
    """Leaves of very different magnitudes: the fp32 sum depends on the
    order, and the port's matches the reference's sorted-key order."""
    vals = {"z": np.full(3, 1e4, np.float32), "a": np.full(5, 1e-3,
                                                            np.float32),
            "m": {"q": np.full(2, 3.0, np.float32)}}
    got = opt_mod.global_norm(_to_torch(vals, torch.float32))
    want = jopt.global_norm(_to_jax(vals, jnp.float32))
    assert float(got) == float(want)
    assert [t.shape[0] for t in opt_mod.sorted_leaves(
        _to_torch(vals, torch.float32))] == [5, 2, 3]


def test_compress_int8_matches_reference():
    g = np.random.RandomState(4).randn(257).astype(np.float32)
    err = 0.01 * np.random.RandomState(5).randn(257).astype(np.float32)
    tdeq, terr = opt_mod.compress_int8(torch.from_numpy(g),
                                       torch.from_numpy(err))
    jdeq, jerr = jopt.compress_int8(jnp.asarray(g), jnp.asarray(err))
    np.testing.assert_allclose(tdeq.numpy(), np.asarray(jdeq), atol=1e-6)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), atol=1e-6)


def _state_trees(dtype):
    p = _np_tree(7)
    jp = _to_jax(p, {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype])
    tp = _to_torch(p, {"float32": torch.float32,
                       "bfloat16": torch.bfloat16}[dtype])
    js = jopt.init_state(jopt.OptConfig(), jp)
    ts = opt_mod.init_state(OptConfig(), tp)
    g = _np_tree(8)
    jp, js = jopt.apply_updates(jopt.OptConfig(), jp, _to_jax(g, jnp.float32),
                                js)
    tp, ts = opt_mod.apply_updates(OptConfig(), tp,
                                   _to_torch(g, torch.float32), ts)
    return jp, js, tp, ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_interop(tmp_path, dtype):
    """Each package restores the other's checkpoint, bitwise."""
    jp, js, tp, ts = _state_trees(dtype)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(d_ref, jp, js, 5)
    ckpt.save(d_port, tp, ts, 5)
    assert ckpt.latest_step(d_ref) == jckpt.latest_step(d_port) == 5
    with np.load(os.path.join(d_ref, "ckpt_00000005.npz")) as a, \
            np.load(os.path.join(d_port, "ckpt_00000005.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
    # the port restores the reference's checkpoint, and the reverse
    tp2, ts2, step = ckpt.try_restore(d_ref, tp, ts)
    assert step == 5
    jp2, js2, step = jckpt.try_restore(d_port, jp, js)
    assert step == 5

    def same(t, j):
        if isinstance(t, dict):
            for k in t:
                same(t[k], j[k])
            return
        if t is None:
            assert j is None
            return
        assert t.dtype == {"float32": torch.float32, "int32": torch.int32,
                           "bfloat16": torch.bfloat16}[str(j.dtype)]
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    same(tp2, jp)
    same(ts2, js)
    same(tp, jp2)
    same(ts, js2)


def test_train_loop_history_matches_reference(tmp_path):
    """``run_train_loop`` with a fault at step 7 on reduced fp32 smollm,
    the reference's weights in both: the same logged steps and losses
    (within 1e-5 relative), both resumed from the step-5 checkpoint with
    the data iterator not rewound."""
    kw = dict(dtype="float32", param_dtype="float32")
    jm = jregistry.build(jconfigs.get_reduced("smollm-135m").replace(**kw))
    tm = registry.build(configs.get_reduced("smollm-135m").replace(**kw))
    jp = jm.init(0)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    vocab = tm.cfg.vocab_size
    hist = []
    for pkg, loader, model, params, d in (
            ("ref", JLoader(lambda rng: jlm_batch(vocab, 2, 16, rng)), jm,
             jp, tmp_path / "ref"),
            ("port", ShardedLoader(lambda rng: lm_batch(vocab, 2, 16, rng)),
             tm, tp, tmp_path / "port")):
        hook, fired = _fault_at(7)
        loop_cfg = TrainLoopConfig(steps=12, log_every=2, checkpoint_every=5,
                                   checkpoint_dir=str(d))
        if pkg == "ref":
            out = jloop.run_train_loop(
                model, jopt.OptConfig(lr=1e-2), loader,
                jloop.TrainLoopConfig(**vars(loop_cfg)), params=params,
                fault_hook=hook, log_fn=lambda *a: None)
        else:
            out = run_train_loop(model, OptConfig(lr=1e-2), loader, loop_cfg,
                                 params=params, fault_hook=hook,
                                 log_fn=lambda *a: None, device="cpu")
        assert fired["n"] == 1
        hist.append(out[2])
    (jh, th) = hist
    # step 6 is logged before the fault and again after the restore
    assert [s for s, _ in th] == [s for s, _ in jh] == [0, 2, 4, 6, 6, 8,
                                                        10]
    np.testing.assert_allclose([v for _, v in th], [v for _, v in jh],
                               rtol=1e-5)


def test_train_cli_runs_on_cpu(capsys, tmp_path):
    assert train_cli.main(["--device", "cpu", "--reduced", "--steps", "4",
                           "--log-every", "2", "--ckpt-dir",
                           str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[train] loss" in out and "over 4 steps" in out
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_train_cli_builds_dlrm():
    args = train_cli.parser().parse_args(["--arch", "rm1", "--reduced",
                                          "--opt", "adagrad", "--batch", "4"])
    model, opt_cfg, loader, loop_cfg = train_cli.build(args)
    batch = next(iter(loader))
    assert opt_cfg.kind == "adagrad" and loop_cfg.steps == 200
    assert set(batch) == {"dense", "indices", "labels"}
    assert batch["indices"].shape[0] == 4
    specs = model.input_specs(4)
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        k: v.shape for k, v in batch.items()}
