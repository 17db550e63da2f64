"""rwkv6's WKV scan under autograd: the token trips in nested checkpointed
chunks, as the reference's ``wkv_chunked`` runs them (CPU only).

The reduced fp32 rwkv6 config with ``ssm.chunk`` 64 at S = 128: two
chunks of four sub-chunks of 16 tokens, so both levels of nesting run.

- The chunked train path against the plain loop (``wkv_scan`` without
  ``chunk``, under autograd): loss and hidden states bitwise; every
  gradient bitwise but ``u``'s, the one leaf whose per-token terms the
  scan itself sums (chunks regroup that sum), which is held within 1e-6
  of its largest magnitude.
- The same path against the reference's ``jax.value_and_grad`` at the
  same chunking, within ``test_torch_loss``'s tolerances.
- Memory: the plain loop saves three (B, H, K, K) states a token for
  its backward (counted with ``saved_tensors_hooks``, which sees every
  saved tensor where no checkpoint runs).  The checkpoints' own storage
  is invisible to such hooks (each checkpoint packs with its own), so
  the chunked loop's is measured as the peak of live storage over its
  forward and backward (``launch.dryrun._Cost`` on real CPU tensors):
  from S = 128 to 256 it grows by the token rows (operands, outputs,
  gradients) and two chunk states, not by three states a token.
- Serving: without grad the scan is the old single loop, op for op
  (four ops a token) and bitwise, and ``time_mix`` passes no chunk.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.models import registry as tregistry
from repro_torch.models import rwkv6
from repro_torch.models.params import tree_map
from repro_torch.models.transformer import params_from_reference
from repro_torch.train import train_loop as tloop

from _torch_zoo import noisy
from test_torch_loss import check_loss_and_grads, lm_batch_for

CHUNK, S = 64, 128


def _reduced(configs):
    cfg = configs.get_reduced("rwkv6-3b").replace(dtype="float32",
                                                  param_dtype="float32")
    return cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=CHUNK))


@pytest.fixture(scope="module")
def both():
    """Both packages' reduced rwkv6 at ``CHUNK``, the reference's weights
    with seeded noise (so that ``u`` and the other zero leaves act)."""
    jm = jregistry.build(_reduced(jconfigs))
    tm = tregistry.build(_reduced(tconfigs))
    jp = jax.tree.map(jnp.asarray, noisy(jm.init(0), 3))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _leaves(tp):
    """A copy of the weights whose leaves require grad, as training's."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(), tp)


def _batch(cfg, S=S):
    return {k: torch.from_numpy(v)
            for k, v in lm_batch_for(cfg, B=2, S=S).items()}


@pytest.fixture
def plain_loop(monkeypatch):
    """``time_mix``'s scan as the plain loop whatever it asks for."""
    scan = rwkv6.wkv_scan
    monkeypatch.setattr(rwkv6, "wkv_scan",
                        lambda *a, chunk=None: scan(*a))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    else:
        yield path, tree


def _chunks_seen(monkeypatch):
    seen = []
    scan = rwkv6.wkv_scan

    def spy(*a, chunk=None):
        seen.append(chunk)
        return scan(*a, chunk=chunk)
    monkeypatch.setattr(rwkv6, "wkv_scan", spy)
    return seen


def test_train_path_is_chunked_and_serving_is_not(both, monkeypatch):
    """Training passes ``cfg.ssm.chunk`` to the scan, and the scan makes
    one checkpoint per chunk and per sub-chunk in the forward; prefill
    and decode, without grad, pass none."""
    _, _, tm, tp = both
    seen = _chunks_seen(monkeypatch)
    calls = []
    orig = rwkv6.checkpoint
    monkeypatch.setattr(rwkv6, "checkpoint",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    tm.forward(_leaves(tp), _batch(tm.cfg), train=True)
    L = tm.cfg.num_layers
    assert seen == [CHUNK] * L
    assert len(calls) == L * (S // CHUNK) * (1 + CHUNK // 16)
    seen.clear()
    with torch.no_grad():
        _, cache = tm.prefill(tp, _batch(tm.cfg))
        tm.decode_step(tp, cache, {"tokens": _batch(tm.cfg)["tokens"][:, :1]})
    assert seen == [None] * 2 * L


def test_chunked_train_path_matches_plain_loop(both, request):
    """Loss, hidden states and gradients of the chunked path against the
    plain loop under autograd: bitwise, but ``u``'s gradient, within
    1e-6 of its largest magnitude."""
    _, _, tm, tp = both
    batch = _batch(tm.cfg)

    def run():
        hidden = tm.forward(_leaves(tp), batch, train=True)[0].detach()
        loss, grads = tloop.value_and_grad(tm, _leaves(tp), batch)
        assert len(dict(_flat(tp))) == len(dict(_flat(grads)))
        return hidden, loss, dict(_flat(grads))

    hc, lc, gc = run()
    request.getfixturevalue("plain_loop")
    hp, lp, gp = run()
    assert torch.equal(hc, hp)
    assert torch.equal(lc, lp)
    for path, g in gp.items():
        if path.endswith("/tm/u"):
            scale = float(g.abs().max())
            assert scale > 0
            assert float((gc[path] - g).abs().max()) <= 1e-6 * scale, path
        else:
            assert torch.equal(gc[path], g), path


def test_chunked_train_path_matches_reference(both):
    """The chunked path against the reference's ``wkv_chunked`` (chunks
    of 64, sub-chunks of 16) under ``jax.value_and_grad``."""
    jm, jp, tm, tp = both
    check_loss_and_grads(jm, jp, tm, tp, lm_batch_for(tm.cfg, B=2, S=S))


def _operands(S, B=2, H=4, K=64, grad=True):
    rng = np.random.RandomState(S)
    r, k, v = (rng.randn(B, S, H, K).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.randn(B, S, H, K))).astype(np.float32)
    u = rng.randn(H, K).astype(np.float32)
    out = [torch.from_numpy(a).requires_grad_(grad) for a in (r, k, v, w, u)]
    return out + [torch.zeros(B, H, K, K)]


def _plain_saved_bytes(S):
    """Bytes of the new storage the plain loop saves for its backward."""
    *ins, s0 = _operands(S)
    held, seen = [], set(id(t.untyped_storage()) for t in ins)

    def pack(t):
        key = id(t.untyped_storage())
        if key not in seen:
            seen.add(key)
            held.append(t.untyped_storage().nbytes())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        rwkv6.wkv_scan(*ins, s0)
    return sum(held)


def _chunked_peak_bytes(S):
    """Peak live storage over the chunked scan's forward and backward,
    less its inputs."""
    *ins, s0 = _operands(S)
    cost = dryrun._Cost([t.untyped_storage() for t in (*ins, s0)])
    g = torch.from_numpy(np.random.RandomState(1).randn(
        *ins[0].shape).astype(np.float32))
    with cost:
        y, _ = rwkv6.wkv_scan(*ins, s0, chunk=CHUNK)
        (y * g).sum().backward()
    return cost.peak


def test_saved_bytes_bounded_by_chunks_not_tokens():
    B, H, K = 2, 4, 64
    state, row = B * H * K * K * 4, B * H * K * 4
    plain = {s: _plain_saved_bytes(s) for s in (S, 2 * S)}
    # the plain loop: three new states a token (k v^T, S + u k v^T and
    # the next state), and the token rows
    for s, n in plain.items():
        assert 3 * s * state <= n <= 3 * s * state + 8 * s * row, (s, n)
    chunked = {s: _chunked_peak_bytes(s) for s in (S, 2 * S)}
    # the chunked loop at S: its chunks' and one chunk's sub-chunks'
    # states, one sub-chunk's trips (three states each, and the trip's
    # gradient buffers), and O(S) token rows
    for s, n in chunked.items():
        nc, ns, qs = s // CHUNK, CHUNK // 16, 16
        assert n <= (nc + ns + 5 * qs) * state + 24 * s * row, (s, n)
    # doubling S adds two chunk states and token rows: far from the
    # plain loop's three states a token
    grow = chunked[2 * S] - chunked[S]
    assert grow <= 2 * state + 24 * S * row, grow
    assert grow < (plain[2 * S] - plain[S]) / 8


def _scan_as_before(r, k, v, w, u, state0):
    """The serving loop before the chunked train path: one trip a token
    over the whole operands."""
    B, S, H, K = r.shape
    rows = r.transpose(1, 2).contiguous()
    ub = u[None, :, :, None]
    St, ys = state0, []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        m = torch.addcmul(St, ub, kv)
        ys.append(torch.bmm(rows[:, :, t].reshape(B * H, 1, K),
                            m.reshape(B * H, K, K)).reshape(B, H, K))
        St = torch.addcmul(kv, w[:, t, :, :, None], St)
    return torch.stack(ys, dim=1), St


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n", [S, 1])
def test_serving_loop_is_the_old_loop(n):
    """Without grad (prefill, and a decode step's one token) the scan
    dispatches the same ops as the loop before it, four a token, and
    gives the same bits."""
    ins = _operands(n, grad=False)
    counted = []
    with torch.no_grad():
        for fn in (rwkv6.wkv_scan, _scan_as_before):
            with _Ops() as mode:
                out = fn(*ins)
            counted.append((mode.ops, out))
    (now, (y, st)), (before, (y0, st0)) = counted
    assert now == before
    assert sum(op.__name__.startswith(("mul", "addcmul", "bmm"))
               for op in now) == 4 * n
    assert torch.equal(y, y0) and torch.equal(st, st0)
