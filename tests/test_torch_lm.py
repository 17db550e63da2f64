"""The port's LM generation path against the JAX package's.

Same numpy inputs through ``repro`` (Pallas kernels in interpret mode,
the jnp model) and ``repro_torch`` (the plain PyTorch versions that the
kernel wrappers take for CPU tensors).  Tolerances:

- kernels, fp32: 2e-5 for attention (the reference's own kernel test),
  1e-4 on o and l and 1e-5 on m for decode partials — the two compute
  the same fp32 arithmetic in another summation order;
- kernels, bf16: both widen the bf16 inputs to fp32 and compute alike,
  so attention is held within two bf16 steps of each element
  (``repro_torch.kernels.cases``) and decode to the fp32 tolerances; the
  one-pass decode oracles round p and o to bf16, as the reference's
  ``decode_attention_local`` does, so they are held to bf16's 2e-2;
- the reduced model in fp32, as smollm has it and with each attention
  option the dense family reads (QKV bias, q/k norm, padded query
  heads): prefill logits within 1e-4 and greedy tokens equal;
- the reduced model in bf16, teacher-forced on the reference's tokens:
  logits within 2e-2, about ten bf16 steps at the logits' magnitude
  (< 0.5): the reference's jnp attention rounds p to bf16 before the PV
  product and keeps decode o in bf16, while the port keeps p, o, l and m
  in fp32, as the Pallas kernels do, and casts o once after combining.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smollm_135m as jcfg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import registry as jregistry
from repro.serving.engine import LMServingEngine as JaxEngine
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs import smollm_135m as tcfg
from repro_torch.kernels import cases
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve
from repro_torch.models import registry as tregistry
from repro_torch.models.transformer import DecoderLM, params_from_reference
from repro_torch.serving.engine import LMServingEngine

ATTN_GRID = [  # B, H, Hkv, S, T, D, q_block, kv_block
    (1, 4, 4, 64, 64, 32, 32, 32),      # G = 1
    (2, 6, 2, 64, 64, 16, 32, 16),      # G = 3
    (1, 3, 1, 32, 64, 16, 32, 32),      # G = 3, S < T
]
DECODE_GRID = [  # B, H, Hkv, T, D, kv_block, pos, kv_offset
    (2, 4, 4, 64, 32, 16, 0, 0),        # pos in the first block
    (2, 4, 4, 64, 32, 16, 30, 0),       # a middle block
    (2, 4, 4, 64, 32, 16, 63, 0),       # the last block
    (2, 6, 2, 64, 16, 32, 40, 0),       # G = 3
    (2, 6, 2, 64, 16, 32, 90, 64),      # kv_offset > 0
    (1, 6, 2, 64, 16, 32, 10, 64),      # a slice wholly after pos
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


# ------------------------------------------------------------- kernels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,Hkv,S,T,D,qb,kb", ATTN_GRID)
def test_flash_attention_plain_vs_pallas(B, H, Hkv, S, T, D, qb, kb,
                                         causal, dtype):
    rng = np.random.RandomState(B * 100 + H * 10 + S)
    jq, tq = _pair(rng.randn(B, H, S, D).astype(np.float32), dtype)
    jk, tk = _pair(rng.randn(B, Hkv, T, D).astype(np.float32), dtype)
    jv, tv = _pair(rng.randn(B, Hkv, T, D).astype(np.float32), dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, q_block=qb,
                                kv_block=kb)
    got = tops.flash_attention(tq, tk, tv, causal=causal, q_block=qb,
                               kv_block=kb)
    assert got.dtype == tq.dtype and got.shape == (B, H, S, D)
    atol, rtol = cases.ATTN_TOL[tq.dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)
    oracle = tref.flash_attention_ref(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(
        _np(oracle), _np(jref.flash_attention_ref(jq, jk, jv, causal=causal)),
        atol=atol, rtol=rtol)


def test_flash_attention_ragged_plain_vs_oracle():
    """Any S and T: a ragged last tile is shorter, never padded."""
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(2, 6, 37, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 2, 45, 16).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 2, 45, 16).astype(np.float32))
    for causal in (True, False):
        got = tops.flash_attention(q, k, v, causal=causal, q_block=16,
                                   kv_block=16)
        want = tref.flash_attention_ref(q, k, v, causal=causal)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,D,kb,pos,off", DECODE_GRID)
def test_flash_decode_plain_vs_pallas(B, H, Hkv, T, D, kb, pos, off, dtype):
    rng = np.random.RandomState(T + D + pos)
    jq, tq = _pair(rng.randn(B, H, D).astype(np.float32), dtype)
    jk, tk = _pair(rng.randn(B, T, Hkv, D).astype(np.float32), dtype)
    jv, tv = _pair(rng.randn(B, T, Hkv, D).astype(np.float32), dtype)
    want = jops.flash_decode_partial(jq, jk, jv, jnp.asarray(pos, jnp.int32),
                                     kv_offset=off, kv_block=kb)
    got = tops.flash_decode_partial(tq, tk, tv,
                                    torch.tensor(pos, dtype=torch.int32),
                                    kv_offset=off, kv_block=kb)
    for g, w, tol in zip(got, want, (1e-4, 1e-4, 1e-5)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol)
    if off > pos:                       # wholly after pos: Pallas values
        o, l, m = got
        assert float(o.abs().max()) == 0.0 and float(l.abs().max()) == 0.0
        assert bool((m == -1e30).all())
    # the one-pass oracles (the reference's decode_attention_local)
    jo, jl, jm = jref.flash_decode_ref(jq, jk, jv, jnp.asarray(pos), off)
    to, tl, tm = tref.flash_decode_ref(tq, tk, tv, pos, kv_offset=off)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(to), _np(jo), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(np.isfinite(_np(tm)), np.isfinite(_np(jm)))
    if pos >= off:
        np.testing.assert_allclose(_np(tm), _np(jm), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(got[2]), _np(tm), atol=1e-5,
                                   rtol=1e-5)


def test_decode_full_ref_matches_reference():
    rng = np.random.RandomState(7)
    q = rng.randn(2, 6, 16).astype(np.float32)
    kc = rng.randn(2, 48, 2, 16).astype(np.float32)
    vc = rng.randn(2, 48, 2, 16).astype(np.float32)
    want = jref.decode_attention_full_ref(jnp.asarray(q), jnp.asarray(kc),
                                          jnp.asarray(vc), jnp.asarray(30))
    got = tref.decode_attention_full_ref(torch.from_numpy(q),
                                         torch.from_numpy(kc),
                                         torch.from_numpy(vc), 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------- the slice


def _configs(kv: int, dtype: str):
    """smollm REDUCED (G = 1) or with one kv head (G = 3, as smollm's
    9/3 has), in ``dtype``, in both packages."""
    kw = dict(num_kv_heads=kv, dtype=dtype, param_dtype=dtype)
    return jcfg.REDUCED.replace(**kw), tcfg.REDUCED.replace(**kw)


def _models(kv: int, dtype: str):
    jc, tc = _configs(kv, dtype)
    jm, tm = jregistry.build(jc), tregistry.build(tc)
    jp = jm.init(0)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _prompt(vocab: int):
    return np.random.RandomState(1).randint(0, vocab, (2, 16)).astype(
        np.int32)


@pytest.mark.parametrize("kv", [3, 1], ids=["G1", "G3"])
def test_fp32_slice_matches_reference(kv):
    jm, jp, tm, tp = _models(kv, "float32")
    toks = _prompt(jm.cfg.vocab_size)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=32)
    tl, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                           cache_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert cache["k"].shape == (2, 2, 32, kv, 16)
    assert int(cache["pos"]) == 15
    hidden, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(hidden), atol=1e-4,
                               rtol=1e-4)
    assert aux == 0.0                   # no MoE, no aux loss
    want = JaxEngine(jm, jp, cache_len=32).generate(toks, steps=6)
    got = LMServingEngine(tm, tp, cache_len=32, device="cpu").generate(
        toks, steps=6)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


OPTIONS = {  # attention options of the dense family that smollm leaves off
    "attn_bias": dict(attn_bias=True),
    "qk_norm": dict(qk_norm=True),
    "pad_heads_to": dict(num_kv_heads=1, pad_heads_to=6),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_fp32_attention_option_matches_reference(option):
    """Each option on the reduced config in fp32.  Every parameter gets
    seeded noise before it crosses over, so the biases and q/k norm
    scales (zero at init) act, and the padded heads' random weights must
    be cancelled by the head mask as in the reference."""
    kw = dict(OPTIONS[option], dtype="float32", param_dtype="float32")
    jm = jregistry.build(jcfg.REDUCED.replace(**kw))
    tm = tregistry.build(tcfg.REDUCED.replace(**kw))
    assert tm.param_count() == jm.param_count()
    rng = np.random.RandomState(3)
    ref = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.randn(
        *a.shape).astype(np.float32), jm.init(0))
    jp = jax.tree.map(jnp.asarray, ref)
    tp = params_from_reference(ref, device="cpu")
    toks = _prompt(jm.cfg.vocab_size)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=32)
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                       cache_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    want = JaxEngine(jm, jp, cache_len=32).generate(toks, steps=6)
    got = LMServingEngine(tm, tp, cache_len=32, device="cpu").generate(
        toks, steps=6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv", [3, 1], ids=["G1", "G3"])
def test_bf16_teacher_forced_logits(kv):
    jm, jp, tm, tp = _models(kv, "bfloat16")
    toks = _prompt(jm.cfg.vocab_size)
    steps = JaxEngine(jm, jp, cache_len=32).generate(toks, steps=6)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=32)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                            cache_len=32)
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tl), _np(jl), atol=2e-2, rtol=0)
    for s in range(steps.shape[1]):
        tok = steps[:, s:s + 1]
        jl, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(tok)})
        tl, tcache = tm.decode_step(tp, tcache,
                                    {"tokens": torch.from_numpy(tok)})
        np.testing.assert_allclose(_np(tl), _np(jl), atol=2e-2, rtol=0,
                                   err_msg=f"decode step {s}")
    assert int(tcache["pos"]) == 15 + steps.shape[1]


def test_params_from_reference_shapes():
    jm, jp, tm, tp = _models(1, "bfloat16")
    flat_j = jax.tree_util.tree_flatten_with_path(jm.param_shapes())[0]
    shapes = tm.param_shapes()
    n = 0
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t, s = tp, shapes
        for k in keys:
            t, s = t[k], s[k]
        assert tuple(t.shape) == tuple(leaf.shape) == tuple(s.shape), keys
        assert t.dtype == s.dtype == torch.bfloat16, keys
        n += 1
    assert n == len(list(jax.tree.leaves(jp)))
    assert tm.param_count() == jm.param_count()
    own = tm.init(0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp))


@pytest.mark.parametrize("name", ["CONFIG", "REDUCED"])
def test_config_matches_reference(name):
    mine, theirs = getattr(tcfg, name), getattr(jcfg, name)
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.resolved_head_dim == theirs.resolved_head_dim
    assert mine.padded_heads == theirs.padded_heads
    assert get_config("smollm-135m") is tcfg.CONFIG
    assert get_reduced("smollm-135m") is tcfg.REDUCED
    assert DecoderLM(mine).param_count() == \
        jregistry.build(theirs).param_count()


def test_unported_families_raise():
    """The recurrent families, once the port's last unported ones, now
    build: every ``hybrid`` config gives a ``Zamba2Model`` and every
    ``ssm`` config an ``RWKV6Model``, full and reduced, as the
    reference's registry builds them; an unknown arch still raises."""
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    from repro_torch.models.mamba2 import Zamba2Model
    from repro_torch.models.rwkv6 import RWKV6Model
    want = {"hybrid": Zamba2Model, "ssm": RWKV6Model}
    built = 0
    for arch in tconfigs.list_archs():
        for get in ("get_config", "get_reduced"):
            cfg = getattr(tconfigs, get)(arch)
            if cfg.family not in want:
                continue
            model = tregistry.build(cfg)
            assert type(model) is want[cfg.family], arch
            ref = jregistry.build(getattr(jconfigs, get)(arch))
            assert type(ref).__name__ == want[cfg.family].__name__
            assert model.param_count() == ref.param_count(), arch
            built += 1
    assert built == 4                 # zamba2-7b and rwkv6-3b, each twice
    assert type(tregistry.build(tcfg.REDUCED.replace(
        family="ssm"))) is RWKV6Model
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_cli_generates_on_cpu(capsys):
    assert serve.main(["--arch", "smollm-135m", "--device", "cpu",
                       "--decode-steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[serve] generated 3 tokens/seq for 2 sequences: [" in out
