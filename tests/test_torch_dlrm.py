"""The port's DLRM against ``repro.models.dlrm`` on the reduced RM1/RM2.

Weights come from the reference's ``init`` through numpy
(``params_from_reference``), inputs from one seeded numpy batch.  The
dense tower's matrix products run in another library, so scores agree
within rtol=1e-5, atol=1e-6 (fp32 rounding through the MLPs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rm1, rm2
from repro.data.queries import dlrm_batch as jax_dlrm_batch
from repro.models.dlrm import DLRMModel as JaxDLRM
from repro.serving.engine import DLRMServingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import counting
from repro_torch.configs import rm1 as trm1
from repro_torch.configs import rm2 as trm2
from repro_torch.data.queries import (QueryDist, dlrm_batch,
                                      dlrm_request_stream)
from repro_torch.models.dlrm import DLRMModel, params_from_reference
from repro_torch.serving.engine import DLRMServingEngine, Request

TOL = dict(rtol=1e-5, atol=1e-6)
CONFIGS = [(rm1.REDUCED, trm1.REDUCED), (rm2.REDUCED, trm2.REDUCED)]


@pytest.fixture(scope="module", params=CONFIGS, ids=["rm1", "rm2"])
def pair(request):
    jcfg, tcfg = request.param
    jm, tm = JaxDLRM(jcfg), DLRMModel(tcfg)
    jp = jm.init(0)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    batch = dlrm_batch(tcfg, 8, np.random.RandomState(0))
    return jm, jp, tm, tp, batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_config_copies_match():
    for jcfg, tcfg in CONFIGS + [(rm1.CONFIG, trm1.CONFIG),
                                 (rm2.CONFIG, trm2.CONFIG)]:
        assert jcfg.name == tcfg.name
        assert (dataclasses.asdict(jcfg.dlrm)
                == dataclasses.asdict(tcfg.dlrm))


def test_batch_copy_matches():
    a = jax_dlrm_batch(rm1.REDUCED, 8, np.random.RandomState(4), alpha=1.05)
    b = dlrm_batch(trm1.REDUCED, 8, np.random.RandomState(4), alpha=1.05)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k])


def test_dense_forward(pair):
    jm, jp, tm, tp, batch = pair
    pooled = np.array(jm.pool_embeddings(jp, jnp.asarray(batch["indices"])))
    want = np.asarray(jm.dense_forward(jp, jnp.asarray(batch["dense"]),
                                       jnp.asarray(pooled)))
    got = tm.dense_forward(tp, torch.from_numpy(batch["dense"]),
                           torch.from_numpy(pooled)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_serve_step(pair, use_kernel):
    jm, jp, tm, tp, batch = pair
    want = np.asarray(jm.serve_step(jp, _jb(batch), use_kernel=use_kernel))
    got = tm.serve_step(tp, _tb(batch), use_kernel=use_kernel).numpy()
    assert got.shape == (8,) and np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(got, want, **TOL)


def test_loss(pair):
    jm, jp, tm, tp, batch = pair
    want = float(jm.loss(jp, _jb(batch)))
    got = float(tm.loss(tp, _tb(batch)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("F", [2, 3, 5, 9, 65])
def test_triu_order(F):
    """The pairwise interaction reads zz at the row-major upper
    triangle: torch.triu_indices(F, F, 1) is jnp.triu_indices(F, k=1)."""
    want = np.stack([np.asarray(a) for a in jnp.triu_indices(F, k=1)])
    assert np.array_equal(torch.triu_indices(F, F, 1).numpy(), want)


def test_init_shapes_seeded_no_global_rng():
    tm = DLRMModel(trm1.REDUCED)
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           JaxDLRM(rm1.REDUCED).param_shapes())
    state = torch.get_rng_state()
    p0 = tm.init(0, device="cpu")
    assert torch.equal(state, torch.get_rng_state())   # no global draws
    assert jax.tree.map(lambda a: tuple(a.shape), p0) == jshapes
    n = sum(t.numel() for t in jax.tree.leaves(p0))
    assert n == counting.dlrm_param_count(trm1.REDUCED)
    again, other = tm.init(0, device="cpu"), tm.init(1, device="cpu")
    assert torch.equal(p0["embed"], again["embed"])
    assert not torch.equal(p0["embed"], other["embed"])
    assert float(p0["bottom"]["b0"].abs().max()) == 0.0
    # the reference's scales: embed ~ N(0, 0.01^2), proj ~ N(0, 0.05^2)
    assert abs(float(p0["embed"].std()) - 0.01) < 1e-3
    assert abs(float(p0["proj"].std()) - 0.05) < 2e-2


def test_serving_engine_matches_reference(pair):
    """Batches of 16 with -1 padding, oversized requests split.  The
    reference pools with its jnp path here (its kernels are held to it
    by tests/test_kernels.py), the port with its kernel wrapper."""
    jm, jp, tm, tp, _ = pair
    stream = dlrm_request_stream(tm.cfg, 6, seed=2,
                                 dist=QueryDist(mean_size=10.0, max_size=40))
    assert any(s > 16 for _, _, s, _ in stream)       # the split path
    want = JaxEngine(jm, jp, batch_size=16).serve(
        [JaxRequest(*t) for t in stream])
    got = DLRMServingEngine(tm, tp, batch_size=16, use_kernel=True,
                            device="cpu").serve([Request(*t) for t in stream])
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.outputs, w.outputs, **TOL)
