"""What the LM zoo's parity tests share (``test_torch_moe.py``,
``test_torch_zoo.py``, ``test_torch_encdec.py``,
``test_torch_recurrent.py``): both packages' reduced
models with the reference's weights carried across, seeded inputs, and
the fp32 and bf16 comparisons.

Tolerances:

- fp32: prefill logits within 1e-4 and greedy tokens equal (the two
  compute the same fp32 arithmetic in another summation order);
- bf16, teacher-forced on the reference's tokens: logits within ten bf16
  steps at the logits' magnitude, ``10 * 2^-8 * max|logits|``.  That is
  ``test_torch_lm.py``'s 2e-2 at its logits' magnitude (< 0.5); the
  reference's init gives some zoo models logits up to about 3.  The
  reason is the same: the reference's jnp attention rounds p to bf16
  before the P V product and keeps decode o in bf16, the port keeps
  them in fp32 as the Pallas kernels do.  The recurrent archs hold the
  port to the reference run op by op (``eager``): compiled, XLA fuses
  chains of bf16 elementwise ops and rounds once where the source (and
  the port) rounds after each op, which alone moves zamba2's reduced
  logits by 13 bf16 steps at their magnitude.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.serving.engine import LMServingEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.models import registry as tregistry
from repro_torch.models.transformer import params_from_reference
from repro_torch.serving.engine import LMServingEngine

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def noisy(tree, seed: int):
    """A reference tree as float32 numpy with seeded noise, so that
    zero-initialised leaves (biases, norm scales, gates) act."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.1 * rng.randn(
        *a.shape).astype(np.float32), tree)


def models(arch: str, dtype: str, noise: bool = True):
    """Both packages' reduced models of ``arch`` in ``dtype`` and the
    reference's weights (plus seeded noise) in each."""
    kw = dict(dtype=dtype, param_dtype=dtype)
    jm = jregistry.build(jconfigs.get_reduced(arch).replace(**kw))
    tm = tregistry.build(tconfigs.get_reduced(arch).replace(**kw))
    jd, _ = DTYPES[dtype]
    ref = jm.init(0)
    if noise:
        ref = noisy(ref, 3)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jd), ref)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def inputs(cfg, B: int = 2, S: int = 16):
    """A seeded prompt (B, S) and the prefill's other inputs, fp32 as the
    CLI sends them: a VLM's ``images``, whisper's ``frames``."""
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = rng.randn(B, cfg.encdec.encoder_seq,
                                    cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        extra["images"] = rng.randn(B, cfg.vlm.num_patches,
                                    cfg.d_model).astype(np.float32)
    return toks, extra


def batches(toks, extra):
    """The same prefill batch for each package."""
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    for k, v in extra.items():
        jb[k], tb[k] = jnp.asarray(v), torch.from_numpy(v)
    return jb, tb


def check_fp32(jm, jp, tm, tp, cache_len: int = 64, steps: int = 8):
    """Prefill logits within 1e-4 and ``steps`` greedy tokens from
    ``generate(extra=)`` equal; returns both prefill caches."""
    toks, extra = inputs(jm.cfg)
    jb, tb = batches(toks, extra)
    jl, jcache = jm.prefill(jp, jb, cache_len=cache_len)
    tl, tcache = tm.prefill(tp, tb, cache_len=cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    want = JaxEngine(jm, jp, cache_len=cache_len).generate(
        toks, steps=steps, extra=extra)
    got = LMServingEngine(tm, tp, cache_len=cache_len,
                          device="cpu").generate(toks, steps=steps,
                                                 extra=extra)
    assert got.dtype == np.int32 and got.shape == (toks.shape[0], steps)
    np.testing.assert_array_equal(got, want)
    return jcache, tcache


def assert_bf16_close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=10 * 2.0 ** -8 * np.abs(want).max(),
                               err_msg=what)


def check_bf16_teacher_forced(jm, jp, tm, tp, cache_len: int = 32,
                              steps: int = 4, eager: bool = False) -> None:
    """Prefill and ``steps`` decode steps on the reference's greedy
    tokens: logits within ten bf16 steps at their magnitude.  With
    ``eager`` the reference's prefill and decode steps run op by op
    (``jax.disable_jit``); its greedy tokens come from its compiled
    engine either way."""
    toks, extra = inputs(jm.cfg)
    jb, tb = batches(toks, extra)
    ref = JaxEngine(jm, jp, cache_len=cache_len).generate(
        toks, steps=steps, extra=extra)
    mode = jax.disable_jit if eager else contextlib.nullcontext
    with mode():
        jl, jcache = jm.prefill(jp, jb, cache_len=cache_len)
    tl, tcache = tm.prefill(tp, tb, cache_len=cache_len)
    assert tl.dtype == torch.bfloat16
    assert_bf16_close(tl, jl, "prefill")
    for s in range(steps):
        tok = ref[:, s:s + 1]
        with mode():
            jl, jcache = jm.decode_step(jp, jcache,
                                        {"tokens": jnp.asarray(tok)})
        tl, tcache = tm.decode_step(tp, tcache,
                                    {"tokens": torch.from_numpy(tok)})
        assert_bf16_close(tl, jl, f"decode step {s}")
