"""The port's MoE FFN against the JAX package's (the MoE archs' models
are in ``test_torch_moe_lm.py``).

Same numpy inputs through ``repro.models.moe`` and
``repro_torch.models.moe``, with the reference's weights carried across
by ``params_from_reference``.  Tolerances:

- routing: expert ids and the kept mask equal exactly; in bf16 the
  router weights are bitwise equal too, in fp32 within 2.5e-7 (two fp32
  steps at 1.0, the weights' largest value: the router's fp32 product
  sums d terms in another order than XLA's, and the softmax's exp is
  another implementation);
- ``moe_apply`` in fp32: output within 1e-5 relative to the output's
  scale (the reference's init draws experts with std 1/sqrt(E), so
  outputs reach 10^2, and the expert products sum d_ff terms in another
  order), aux within 1e-5; in bf16 more than 99% of the output's
  elements are bitwise equal, because the port's combine adds each
  token's slots in the reference's scatter order, and the rest within
  two bf16 steps of the element or one of the output's scale (a bf16
  product may round the other way where its fp32 terms add in another
  order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_zoo as zoo
from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import params as jpm
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import params_from_reference



def _moe_params(cfg, dtype):
    jd, _ = zoo.DTYPES[dtype]
    ref = zoo.noisy(jpm.init_table(jax.random.PRNGKey(0), jmoe.moe_table(cfg),
                                jnp.float32), 0)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jd), ref)
    return jp, params_from_reference(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _reference_keep(ids, Ep: int, capacity: int) -> np.ndarray:
    """The reference's kept mask (``moe._moe_local``'s own formula, which
    it does not return) on its route ids."""
    T, k = ids.shape
    onehot = jax.nn.one_hot(ids.reshape(T * k), Ep, dtype=jnp.float32)
    pos = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1).astype(jnp.int32) - 1
    return np.asarray(pos < capacity).reshape(T, k)


CASES = {  # arch, B, S, capacity_factor, top_k (None: the config's)
    "shared_padded": ("qwen2-moe-a2.7b", 2, 24, None, None),
    "shared_padded_drops": ("qwen2-moe-a2.7b", 2, 24, 0.5, None),
    "shared_padded_decode": ("qwen2-moe-a2.7b", 4, 1, None, None),
    # four slots a token, as the full qwen2-moe has: the combine's order
    # of adds matters from three on
    "shared_padded_top4": ("qwen2-moe-a2.7b", 2, 24, None, 4),
    "top2_drops": ("phi3.5-moe-42b-a6.6b", 2, 24, 0.5, None),
    "top2_decode": ("phi3.5-moe-42b-a6.6b", 4, 1, None, None),
}


def _config(module, arch: str, dtype: str, top_k=None):
    cfg = module.get_reduced(arch).replace(dtype=dtype, param_dtype=dtype)
    if top_k is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, top_k=top_k))
    return cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_reference(case, dtype):
    arch, B, S, cf, top_k = CASES[case]
    jcfg = _config(jconfigs, arch, dtype, top_k)
    tcfg = _config(tconfigs, arch, dtype, top_k)
    jd, td = zoo.DTYPES[dtype]
    jp, tp = _moe_params(jcfg, dtype)
    x = np.random.RandomState(B * S).randn(B, S, jcfg.d_model).astype(
        np.float32)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)

    jw, jids, _ = jmoe._route(jx.reshape(B * S, -1), jp["router"], jcfg)
    tw, tids, _ = tmoe._route(tx.reshape(B * S, -1), tp["router"], tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(tw.float().numpy(),
                                      np.asarray(jw, np.float32))
    else:
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=2.5e-7,
                                   rtol=0)
    m = jcfg.moe
    cap = max(8, int(B * S * m.top_k / m.num_experts
                     * (cf or m.capacity_factor)))
    _, keep = tmoe.dispatch(tids, m.padded_experts, cap)
    want_keep = _reference_keep(jids, m.padded_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if case.endswith("drops"):
        assert (~want_keep).sum() > 0, "the case must drop pairs"
    if case.endswith("decode"):
        assert want_keep.all()

    jy, jaux = jmoe.moe_apply(jp, jx, jcfg, capacity_factor=cf)
    ty, taux = tmoe.moe_apply(tp, tx, tcfg, capacity_factor=cf)
    assert ty.dtype == td and ty.shape == (B, S, jcfg.d_model)
    want = np.asarray(jy, np.float32)
    got = ty.float().numpy()
    if dtype == "bfloat16":
        # a bf16 product may round the other way where the two sum its
        # fp32 terms in another order; the combine's adds do not
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                                   atol=2.0 ** -8 * np.abs(want).max())
        assert np.mean(got != want) < 0.01
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-5)
