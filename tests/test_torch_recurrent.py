"""The port's recurrent LM families against the JAX package's: zamba2
(Mamba2 layers and a shared attention block, ``models/mamba2``) and
rwkv6 (``models/rwkv6``).

Every test feeds the same seeded numpy inputs to the reference (as its
own tests run it, on the CPU) and to the port (``device="cpu"``, the
kernels' plain versions), with the reference's weights carried over by
``params_from_reference``.  Tolerances:

- per module, fp32: outputs and states within 1e-5 (``atol`` and
  ``rtol``): the same fp32 arithmetic, summed in another order;
- per module, bf16: ``_torch_zoo``'s ten bf16 steps at the output's
  magnitude (the modules round where the reference's source rounds);
- whole models: ``_torch_zoo``'s rules, fp32 prefill logits within 1e-4
  and 8 greedy tokens equal, and the prefill cache leaf by leaf within
  the logits' 1e-4 (it leaves the same chain of layers: zamba2's attn_k
  after three Mamba2 layers differs by up to 2.8e-5);
  bf16 teacher-forced logits within ten bf16 steps of the reference run
  op by op (``_torch_zoo`` says why).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_zoo as zoo
from repro.models import layers as jlayers
from repro.models import mamba2 as jm2
from repro.models import rwkv6 as jr6
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tm2
from repro_torch.models import params as pm
from repro_torch.models import rwkv6 as tr6

RECURRENT_ARCHS = ["zamba2-7b", "rwkv6-3b"]
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = 1e-5


def _both(a: np.ndarray, dtype: str):
    """One fp32 numpy array as the reference's and the port's input in
    ``dtype``."""
    return (jnp.asarray(a, JD[dtype]),
            torch.from_numpy(np.asarray(a, np.float32)).to(TD[dtype]))


def _close(got: torch.Tensor, want, dtype: str, what: str,
           tol: float = TOL) -> None:
    """fp32 within ``tol``; bf16 inputs within ten bf16 steps at the
    magnitude of ``want`` (fp32 states computed from them too)."""
    if dtype == "float32":
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol, err_msg=what)
    else:
        zoo.assert_bf16_close(got, want, what)


def _tree_close(got, want, what: str, dtype: str = "float32",
                tol: float = TOL) -> int:
    """Leaf by leaf, the same keys and shapes; returns the number of
    leaves."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        return sum(_tree_close(got[k], want[k], f"{what}/{k}", dtype, tol)
                   for k in want)
    assert tuple(got.shape) == np.shape(want), what
    _close(got, want, dtype, what, tol)
    return 1


def _leaves(tree, fn, path=()):
    """{path: fn(leaf)} over a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, fn, path + (k,)))
        return out
    return {path: fn(tree)}


def _layer(arch: str, dtype: str, which):
    """One layer's parameters of the reduced ``arch`` (noisy reference
    weights) in both packages, and the configs."""
    jm, jp, tm, tp = zoo.models(arch, dtype)
    return (which(jp), which(tp)), (jm.cfg, tm.cfg)


# ------------------------------------------------------------ mamba2


@pytest.mark.parametrize("S,target", [(64, 32), (48, 32), (37, 32), (1, 8),
                                      (512, 256), (100, 256)])
def test_pick_block_matches_reference(S, target):
    assert tlayers.pick_block(S, target) == jlayers.pick_block(S, target)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state, dtype):
    rng = np.random.RandomState(5)
    (uj, ut), (wj, wt) = (_both(rng.randn(2, 9, 24), dtype),
                          _both(rng.randn(4, 24), dtype))
    sj = st = None
    if with_state:
        sj, st = _both(rng.randn(2, 3, 24), dtype)
    yj, nj = jm2._causal_conv(uj, wj, sj)
    yt, nt = tm2._causal_conv(ut, wt, st)
    assert yt.dtype == TD[dtype]
    _close(yt, yj, dtype, "y")
    _close(nt, nj, dtype, "state")
    assert tuple(nt.shape) == (2, 3, 24)


def _ssd_inputs(rng, B, S, H, P, N, dtype, h0: bool):
    x, Bm, Cm = (rng.randn(B, S, H, P), rng.randn(B, S, N),
                 rng.randn(B, S, N))
    dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
    A = -np.exp(0.5 * rng.randn(H)).astype(np.float32)
    hs = rng.randn(B, H, P, N).astype(np.float32) if h0 else None
    j = [jnp.asarray(x, JD[dtype]), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bm, JD[dtype]), jnp.asarray(Cm, JD[dtype])]
    t = [_both(x, dtype)[1], torch.from_numpy(dt), torch.from_numpy(A),
         _both(Bm, dtype)[1], _both(Cm, dtype)[1]]
    return (j, None if hs is None else jnp.asarray(hs),
            t, None if hs is None else torch.from_numpy(hs))


@pytest.mark.parametrize("S,chunk,h0,dtype", [
    (64, 32, False, "float32"),       # two chunks of 32
    (48, 32, False, "float32"),       # pick_block cuts chunks of 24
    (37, 32, False, "float32"),       # 37 is prime: chunks of 1
    (96, 32, True, "float32"),        # three chunks after a given state
    (40, 32, True, "bfloat16"),       # chunks of 20, bf16 x, B and C
])
def test_ssd_chunked_matches_reference(S, chunk, h0, dtype):
    rng = np.random.RandomState(S)
    j, jh, t, th = _ssd_inputs(rng, 2, S, 3, 8, 4, dtype, h0)
    yj, hj = jm2.ssd_chunked(*j, chunk, h0=jh)
    yt, ht = tm2.ssd_chunked(*t, chunk, h0=th)
    assert yt.dtype == TD[dtype] and ht.dtype == torch.float32
    _close(yt, yj, dtype, "y")
    _close(ht, hj, dtype, "h_final")


def test_segsum_masks_before_exp():
    """-inf above the diagonal and no NaN after the exp, even where the
    cumulative sums are large."""
    a = torch.tensor([[-1e30, -1e30, 3.0, -2.0]])
    got = tm2._segsum(a)
    assert bool(torch.isneginf(got[0].triu(1)[0, 1:]).all())
    assert not bool(torch.isnan(torch.exp(got)).any())
    rng = np.random.RandomState(0)
    a = rng.randn(3, 7).astype(np.float32)
    np.testing.assert_allclose(tm2._segsum(torch.from_numpy(a)).numpy(),
                               np.asarray(jm2._segsum(jnp.asarray(a))),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_apply_prefill_and_decode(dtype):
    """The prefill branch (``ssd_chunked``) and, from its states, the
    one-token decode branch (the recurrence), each with its new SSM and
    conv states."""
    (lj, lt), (cj, ct) = _layer("zamba2-7b", dtype,
                                lambda p: pm.tree_map(lambda a: a[0, 1],
                                                      p["groups"]))
    rng = np.random.RandomState(2)
    xj, xt = _both(rng.randn(2, 16, cj.d_model), dtype)
    yj, hj, cvj = jm2.mamba2_apply(lj, xj, cj)
    yt, ht, cvt = tm2.mamba2_apply(lt, xt, ct)
    assert yt.dtype == TD[dtype] and ht.dtype == torch.float32
    _close(yt, yj, dtype, "prefill y")
    _close(ht, hj, dtype, "prefill ssm")
    _tree_close(cvt, cvj, "prefill conv", dtype)
    x1j, x1t = _both(rng.randn(2, 1, cj.d_model), dtype)
    y2j, h2j, cv2j = jm2.mamba2_apply(lj, x1j, cj, ssm_state=hj,
                                      conv_state=cvj)
    y2t, h2t, cv2t = tm2.mamba2_apply(lt, x1t, ct, ssm_state=ht,
                                      conv_state=cvt)
    assert tuple(y2t.shape) == (2, 1, cj.d_model)
    _close(y2t, y2j, dtype, "decode y")
    _close(h2t, h2j, dtype, "decode ssm")
    _tree_close(cv2t, cv2j, "decode conv", dtype)


# ------------------------------------------------------------- rwkv6


def test_wkv_scan_matches_reference():
    """The token loop against the reference's nested ``wkv_chunked``
    (chunks of 16, sub-chunks of 4) and its flat ``_wkv_scan``."""
    rng = np.random.RandomState(7)
    B, S, H, K = 2, 40, 3, 8
    r, k, v = (rng.randn(B, S, H, K).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.randn(B, S, H, K))).astype(np.float32)
    u = rng.randn(H, K).astype(np.float32)
    s0 = rng.randn(B, H, K, K).astype(np.float32)
    yt, st = tr6.wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u,
                                                           s0)))
    for yj, sj in (jr6.wkv_chunked(*map(jnp.asarray, (r, k, v, w, u, s0)),
                                   chunk=16, sub=4),
                   jr6._wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))):
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [12, 1])
def test_time_mix_and_channel_mix(S, dtype):
    """Prefill (S = 12) and a decode step (S = 1, the shift reads the
    carried token): outputs, carried tokens and the WKV state.  The group
    norm takes the population variance; the unbiased one is K / (K - 1)
    = 16 / 15 times larger here and misses 1e-5 by far."""
    (lj, lt), (cj, ct) = _layer("rwkv6-3b", dtype,
                                lambda p: pm.tree_map(lambda a: a[1],
                                                      p["layers"]))
    rng = np.random.RandomState(S)
    H, K = cj.num_heads, cj.resolved_head_dim
    xj, xt = _both(rng.randn(2, S, cj.d_model), dtype)
    pj, pt = _both(rng.randn(2, cj.d_model), dtype)
    s0 = rng.randn(2, H, K, K).astype(np.float32)
    oj, prj, sj = jr6.time_mix(lj["tm"], xj, cj, pj, jnp.asarray(s0))
    ot, prt, st = tr6.time_mix(lt["tm"], xt, ct, pt, torch.from_numpy(s0))
    assert ot.dtype == TD[dtype] and st.dtype == torch.float32
    _close(ot, oj, dtype, "time_mix out")
    _close(prt, prj, dtype, "time_mix carried token")
    _close(st, sj, dtype, "WKV state")
    cj_out, cpj = jr6.channel_mix(lj["cm"], xj, pj)
    ct_out, cpt = tr6.channel_mix(lt["cm"], xt, pt)
    _close(ct_out, cj_out, dtype, "channel_mix out")
    _close(cpt, cpj, dtype, "channel_mix carried token")


# ------------------------------------------------------- whole models


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_init_draws_the_tables(arch):
    """The port's own init gives the reference's tree (paths, shapes,
    dtype) with ``param_count()`` leaves' elements, the constant leaves
    as the tables say (rwkv6's decay ``const:-6.0``; mamba2's ``A_log``
    zeros and ``D`` ones), from an explicit seed."""
    jm, jp, tm, tp = zoo.models(arch, "bfloat16", noise=False)
    own = tm.init(0, device="cpu")
    info = lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1])
    assert (_leaves(own, info) == _leaves(jp, info)
            == _leaves(tm.param_shapes(), info))
    assert sum(t.numel() for t in pm.tree_leaves(own)) == tm.param_count()
    assert tm.param_count() == jm.param_count()
    if arch == "rwkv6-3b":
        assert bool((own["layers"]["tm"]["decay"] == -6.0).all())
    else:
        assert not own["groups"]["A_log"].any()
        assert bool((own["tail"]["D"] == 1).all())
        assert tuple(own["groups"]["in_x"].shape[:2]) == (tm.n_groups,
                                                          tm.group)
    again = tm.init(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(pm.tree_leaves(own),
                                                pm.tree_leaves(again)))


CACHE_LEAVES = {"zamba2-7b": 9, "rwkv6-3b": 4}


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_fp32_recurrent_arch_matches_reference(arch):
    """Prefill logits within 1e-4, 8 greedy tokens through
    ``LMServingEngine.generate`` equal, and the cache after prefill
    (zamba2: ``attn_k``, ``attn_v``, ``group_ssm``, ``group_conv``,
    ``tail_*``, ``pos``; rwkv6: ``tm_state``, ``tm_prev``, ``cm_prev``,
    ``pos``) equal leaf by leaf within 1e-4."""
    jm, jp, tm, tp = zoo.models(arch, "float32")
    jcache, tcache = zoo.check_fp32(jm, jp, tm, tp)
    assert _tree_close(tcache, jcache, arch, tol=1e-4) == CACHE_LEAVES[arch]
    assert tcache["pos"].dtype == torch.int32


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_forward_matches_reference(arch):
    """The full-sequence forward (hidden states after the final norm;
    rwkv6's new states too) within the logits' 1e-4."""
    jm, jp, tm, tp = zoo.models(arch, "float32")
    toks, _ = zoo.inputs(tm.cfg)
    jx, jrest = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tx, trest = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(tx, jx, "float32", "hidden", tol=1e-4)
    if arch == "rwkv6-3b":
        for t, j, name in zip(trest, jrest, ("tm_state", "tm_prev",
                                             "cm_prev")):
            _close(t, j, "float32", name, tol=1e-4)
    else:
        assert trest == jrest == 0.0


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_bf16_recurrent_arch_teacher_forced_logits(arch):
    zoo.check_bf16_teacher_forced(*zoo.models(arch, "bfloat16", noise=False),
                                  eager=True)


def test_zamba2_decode_writes_the_cache_in_place():
    """A decode step writes the shared block's KV at ``pos`` and every
    layer's states into the cache's own buffers, advancing a device
    ``pos``; rwkv6 returns new state tensors and leaves its input's."""
    jm, jp, tm, tp = zoo.models("zamba2-7b", "float32")
    toks, _ = zoo.inputs(tm.cfg)
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                          cache_len=24)
    before = pm.tree_map(torch.clone, cache)
    tok = torch.from_numpy(toks[:, :1])
    _, after = tm.decode_step(tp, cache, {"tokens": tok})
    assert after["attn_k"] is cache["attn_k"]
    assert after["group_ssm"] is cache["group_ssm"]
    assert int(after["pos"]) == 16 and int(cache["pos"]) == 15
    assert not torch.equal(cache["group_ssm"], before["group_ssm"])
    assert not torch.equal(cache["attn_k"][:, :, 16],
                           before["attn_k"][:, :, 16])
    assert torch.equal(cache["attn_k"][:, :, :16],
                       before["attn_k"][:, :, :16])
    jm, jp, rm, rp = zoo.models("rwkv6-3b", "float32")
    _, rc = rm.prefill(rp, {"tokens": torch.from_numpy(toks)})
    rbefore = pm.tree_map(torch.clone, rc)
    _, rafter = rm.decode_step(rp, rc, {"tokens": tok})
    assert all(torch.equal(a, b) for a, b in zip(pm.tree_leaves(rc),
                                                pm.tree_leaves(rbefore)))
    assert not torch.equal(rafter["tm_state"], rc["tm_state"])
