"""Loss and gradient parity of the port's training path with the
reference's ``jax.value_and_grad``, in fp32 on the reduced configs.

Both packages get the same numpy inputs and the reference's weights
(plus seeded noise, so that zero-initialised leaves act).  Tolerances,
each fp32 arithmetic in another summation order:

- ``flash_attention_blocked`` against ``flash_attention_jnp``: output
  and the gradients of q, k and v within 1e-5 (absolute; the operands
  are O(1));
- every family's loss within 1e-5 relative, and every leaf's gradient
  within ``GRAD_ATOL`` of the reference's plus 1e-4 of its magnitude;
- parameters after 3 Adam steps of ``make_train_step`` within 2e-5
  (three updates of at most lr = 1e-3 each, whose m / sqrt(v) is
  sensitive to a gradient's last bits where the gradient is small).

It also holds the F1 fault shut: the loss path gives ``wq``, ``wk`` and
``wv`` a nonzero gradient, and ``ops.refuse_grad``, which every CUDA
wrapper calls before its launch, refuses grad-requiring operands.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import registry as jregistry
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch import configs as tconfigs
from repro_torch.data.queries import dlrm_batch
from repro_torch.kernels import ops
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import layers as TL
from repro_torch.models import registry as tregistry
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import params_from_reference
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop

from _torch_zoo import models, noisy

GRAD_ATOL = 1e-6
LM_ARCHS = ["smollm-135m", "qwen2-moe-a2.7b", "llava-next-mistral-7b",
            "whisper-large-v3", "zamba2-7b", "rwkv6-3b"]


# ------------------------------------------------------------ attention


@pytest.mark.parametrize(
    "B,S,T,H,Hkv,D,causal,q_offset,kv_len,qb,kb", [
        (2, 16, 16, 4, 2, 8, True, 0, None, 8, 8),      # GQA, causal
        (1, 12, 20, 3, 1, 8, False, 0, 13, 4, 8),       # kv_len, G = 3
        (2, 8, 24, 4, 4, 16, True, 16, None, 8, 16),    # q_offset
        (1, 10, 10, 2, 2, 8, False, 0, None, 4, 4),     # ragged blocks
        (2, 8, 16, 4, 2, 8, True, 0, 11, 8, 4),         # both masks
    ])
def test_flash_attention_blocked_matches_jnp(B, S, T, H, Hkv, D, causal,
                                             q_offset, kv_len, qb, kb):
    rng = np.random.RandomState(S * 7 + T)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, T, Hkv, D).astype(np.float32)
    v = rng.randn(B, T, Hkv, D).astype(np.float32)
    g = rng.randn(B, S, H, D).astype(np.float32)
    kw = dict(causal=causal, q_offset=q_offset, q_block=qb, kv_block=kb)

    def jf(q, k, v):
        o = JL.flash_attention_jnp(
            q, k, v, **kw,
            kv_len=None if kv_len is None else jnp.asarray(kv_len))
        return jnp.sum(o * g), o

    (_, want), jgrads = jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = TL.flash_attention_blocked(
        tq, tk, tv, **kw,
        kv_len=None if kv_len is None else torch.tensor(kv_len))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    for t, jg, name in zip((tq, tk, tv), jgrads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=1e-5, rtol=0, err_msg=name)


# ------------------------------------------------------------ the models


def lm_batch_for(cfg, B=2, S=16, seed=0, mask=False):
    """tokens, labels and the family's other inputs, numpy."""
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.randn(B, cfg.encdec.encoder_seq,
                                cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        b["images"] = rng.randn(B, cfg.vlm.num_patches,
                                cfg.d_model).astype(np.float32)
    if mask:
        b["loss_mask"] = (rng.rand(B, S) < 0.7).astype(np.float32)
    return b


def assert_grads_close(tgrads, jgrads, path=""):
    if isinstance(tgrads, dict):
        assert sorted(tgrads) == sorted(jgrads), path
        for k in tgrads:
            assert_grads_close(tgrads[k], jgrads[k], f"{path}/{k}")
        return
    want = np.asarray(jgrads, np.float32)
    np.testing.assert_allclose(
        tgrads.numpy(), want, rtol=1e-4,
        atol=GRAD_ATOL + 1e-4 * np.abs(want).max(), err_msg=path)


def check_loss_and_grads(jm, jp, tm, tp, batch):
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = tloop.value_and_grad(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert_grads_close(tgrads, jgrads)
    return tgrads


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_family_loss_and_grads_match_reference(arch):
    jm, jp, tm, tp = models(arch, "float32")
    check_loss_and_grads(jm, jp, tm, tp, lm_batch_for(tm.cfg))


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_dense_remat_modes_and_loss_mask(remat):
    jm, jp, tm, tp = models("smollm-135m", "float32")
    jm.cfg = jm.cfg.replace(remat=remat)
    tm.cfg = tm.cfg.replace(remat=remat)
    check_loss_and_grads(jm, jp, tm, tp,
                         lm_batch_for(tm.cfg, mask=True, seed=1))


def test_dense_chunked_ce_matches_reference():
    """S = 2048: the CE runs in two checkpointed chunks of 1024."""
    jm, jp, tm, tp = models("smollm-135m", "float32")
    check_loss_and_grads(jm, jp, tm, tp, lm_batch_for(tm.cfg, B=1, S=2048))


def test_attention_weights_get_gradients():
    """The F1 symptom: on the loss path wq, wk and wv get a gradient (on
    the card the kernel path would give them none)."""
    jm, jp, tm, tp = models("smollm-135m", "float32")
    batch = {k: torch.from_numpy(v)
             for k, v in lm_batch_for(tm.cfg).items()}
    _, grads = tloop.value_and_grad(tm, tp, batch)
    for name in ("wq", "wk", "wv", "wo"):
        g = grads["layers"]["attn"][name]
        assert g.shape == tp["layers"]["attn"][name].shape
        assert bool(torch.isfinite(g).all())
        for layer in g:
            assert float(layer.abs().max()) > 0, name


def test_dlrm_loss_and_grads_match_reference():
    cfg_j = jconfigs.get_reduced("rm1")
    cfg_t = tconfigs.get_reduced("rm1")
    jm, tm = jregistry.build(cfg_j), tregistry.build(cfg_t)
    ref = noisy(jm.init(0), 3)
    jp = jax.tree.map(jnp.asarray, ref)
    tp = tdlrm.params_from_reference(ref, device="cpu")
    batch = dlrm_batch(cfg_t, 16, np.random.RandomState(0))
    grads = check_loss_and_grads(jm, jp, tm, tp, batch)
    assert float(grads["embed"].abs().max()) > 0


def test_refuse_grad_guard():
    """``ops.refuse_grad`` (called by every CUDA wrapper before its
    launch) refuses an operand that requires grad while grad mode is on,
    and names the kernel."""
    x = torch.zeros(2, 3, requires_grad=True)
    y = torch.zeros(2, 3)
    with pytest.raises(RuntimeError, match="flash_attention.*no backward"):
        ops.refuse_grad("flash_attention", y, x)
    ops.refuse_grad("flash_attention", y, y)
    with torch.no_grad():
        ops.refuse_grad("flash_attention", x)
    # the CPU branch, the plain version, stays differentiable
    q = torch.randn(1, 2, 4, 8, requires_grad=True)
    ops.flash_attention(q, q.detach(), q.detach()).sum().backward()
    assert q.grad is not None and float(q.grad.abs().max()) > 0


# ------------------------------------------------------------ train step


@pytest.mark.parametrize("microbatches", [1, 2])
def test_adam_steps_match_reference(microbatches):
    """Parameters after 3 Adam steps of ``make_train_step``."""
    jm, jp, tm, tp = models("smollm-135m", "float32")
    cfg = dict(lr=1e-3)
    jstep = jax.jit(jloop.make_train_step(jm, jopt.OptConfig(**cfg),
                                          microbatches))
    tstep = tloop.make_train_step(tm, topt.OptConfig(**cfg), microbatches)
    js = jopt.init_state(jopt.OptConfig(**cfg), jp)
    ts = topt.init_state(topt.OptConfig(**cfg), tp)
    for s in range(3):
        batch = lm_batch_for(tm.cfg, B=4, seed=10 + s)
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tp, ts, tmet = tstep(tp, ts, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
    assert int(ts["step"]) == 3
    want = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")

    def close(a, b):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=2e-5,
                                   rtol=0)
    tree_map(close, tp, want)


# ----------------------------------------------------------------- specs


def _spec_tree(tree):
    """{path: (shape, dtype name)} of a tree of ShapeDtypeStructs or
    meta tensors."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out["/".join(path)] = (tuple(t.shape),
                                   str(t.dtype).replace("torch.", ""))
    walk(tree, ())
    return out


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    from repro.configs.base import shape_applicable as jsa
    from repro_torch.configs.base import shape_applicable as tsa
    for arch in jconfigs.ASSIGNED_ARCHS:
        for name in jconfigs.SHAPES:
            assert tsa(tconfigs.get_config(arch), tconfigs.SHAPES[name]) \
                == jsa(jconfigs.get_config(arch), jconfigs.SHAPES[name])


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED_ARCHS + ["rm1"])
def test_input_and_cache_specs_match_reference(arch):
    jm = jregistry.build(jconfigs.get_config(arch))
    tm = tregistry.build(tconfigs.get_config(arch))
    for name, shape in tconfigs.SHAPES.items():
        jshape = jconfigs.SHAPES[name]
        got = tm.input_specs(shape)
        assert all(t.device.type == "meta" for t in got.values())
        assert _spec_tree(got) == _spec_tree(jm.input_specs(jshape))
        if arch == "rm1":
            continue
        assert _spec_tree(tm.cache_specs(shape)) == _spec_tree(
            jm.cache_specs(jshape))
    small = tconfigs.ShapeConfig("tiny", 8, 2, "decode")
    tm = tregistry.build(tconfigs.get_reduced(arch))
    if arch != "rm1":
        cache = tm.init_cache(small, device="cpu")
        assert _spec_tree(cache) == _spec_tree(tm.cache_specs(small))
        assert all(float(t.abs().max()) == 0 for t in tree_leaves(cache)
                   if t.numel())


def test_blocked_causal_skip_is_bitwise():
    """A static ``q_offset`` lets the causal blocked attention skip the kv
    blocks wholly after a q block; a tensor offset visits them all, as
    the reference does.  The outputs and gradients are bitwise equal."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(2, 32, 4, 8).astype(np.float32))
               for _ in range(3))
    outs = []
    for off in (0, torch.tensor(0)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = TL.flash_attention_blocked(*leaves, causal=True, q_offset=off,
                                       q_block=8, kv_block=8)
        o.square().sum().backward()
        outs.append([o.detach()] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
