"""The port's encoder-decoder (whisper) and VLM (llava) archs against the
JAX package's, on their reduced configs, with the reference's weights
carried across.

Whisper: the encoder's output and the prefill's caches (self and cross
K/V) within 1e-4 in fp32, fp32 frames meeting bf16 weights in fp32 as
JAX promotes them, and a cross-attention decode step over the whole
cross cache (a device ``pos`` past its last row).  Llava: the projected
image prefix within 1e-5 in fp32 and positions over the whole sequence.
Both generate through ``generate(extra=)`` with ``_torch_zoo``'s
tolerances: fp32 prefill logits within 1e-4 and 8 greedy tokens equal,
bf16 teacher-forced logits (fp32 frames and images, as the CLI sends
them) within ten bf16 steps at their magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_zoo as zoo

ARCHS = ["whisper-large-v3", "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_arch_matches_reference(arch):
    jm, jp, tm, tp = zoo.models(arch, "float32")
    assert tm.param_count() == jm.param_count()
    jcache, tcache = zoo.check_fp32(jm, jp, tm, tp)
    assert sorted(tcache) == sorted(jcache)
    for key in sorted(tcache):
        if key == "pos":
            assert int(tcache[key]) == int(jcache[key])
            continue
        assert tuple(tcache[key].shape) == tuple(jcache[key].shape), key
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-4,
                                   rtol=1e-4, err_msg=key)


def test_fp32_whisper_encode_matches_reference():
    jm, jp, tm, tp = zoo.models("whisper-large-v3", "float32")
    _, extra = zoo.inputs(jm.cfg)
    frames = extra["frames"]
    want = jm.encode(jp, jnp.asarray(frames))
    got = tm.encode(tp, torch.from_numpy(frames))
    assert got.shape == (2, jm.cfg.encdec.encoder_seq, jm.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_whisper_fp32_frames_promote_bf16_weights():
    """fp32 frames with bf16 weights: the encoder and the cross K/V run in
    fp32 (JAX's promotion), the caches hold bf16, the logits are bf16."""
    jm, jp, tm, tp = zoo.models("whisper-large-v3", "bfloat16",
                                noise=False)
    toks, extra = zoo.inputs(jm.cfg)
    frames = torch.from_numpy(extra["frames"])
    enc = tm.encode(tp, frames)
    assert enc.dtype == torch.float32
    np.testing.assert_allclose(
        enc.numpy(), np.asarray(jm.encode(jp, jnp.asarray(extra["frames"]))),
        atol=1e-4, rtol=1e-4)
    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                    "frames": frames}, cache_len=32)
    assert logits.dtype == torch.bfloat16
    assert cache["cross_k"].dtype == cache["k"].dtype == torch.bfloat16


def test_llava_image_prefix_matches_reference():
    jm, jp, tm, tp = zoo.models("llava-next-mistral-7b", "float32")
    toks, extra = zoo.inputs(jm.cfg)
    jb, tb = zoo.batches(toks, extra)
    jx, jpos = jm._embed_inputs(jp, jb)
    tx, tpos = tm._embed_inputs(tp, tb)
    P = jm.cfg.vlm.num_patches
    assert tx.shape == (2, P + toks.shape[1], jm.cfg.d_model)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_arch_teacher_forced_logits(arch):
    zoo.check_bf16_teacher_forced(*zoo.models(arch, "bfloat16",
                                              noise=False))


def test_whisper_decode_reads_the_whole_cross_cache():
    """A decode step's cross-attention covers every encoder row: changing
    the last cross-cache row changes the logits (and the step leaves the
    cross cache as it was)."""
    jm, jp, tm, tp = zoo.models("whisper-large-v3", "float32")
    toks, extra = zoo.inputs(jm.cfg)
    _, tb = zoo.batches(toks, extra)
    _, cache = tm.prefill(tp, tb, cache_len=24)
    tok = {"tokens": torch.from_numpy(toks[:, -1:])}
    base = {k: v.clone() for k, v in cache.items()}
    want, after = tm.decode_step(tp, dict(base), tok)
    assert torch.equal(after["cross_k"], cache["cross_k"])
    moved = {k: v.clone() for k, v in cache.items()}
    moved["cross_v"][:, :, -1] += 1.0
    got, _ = tm.decode_step(tp, moved, tok)
    assert not torch.allclose(got, want)
