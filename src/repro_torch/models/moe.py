"""Mixture-of-experts FFN, in PyTorch: the counterpart of
``repro.models.moe``.

DisaggRec mapping: experts are the "memory nodes", large parameter pools
touched sparsely per token, and the combine is the Fsum pattern (each
expert's outputs are reduced into the token's row before anything
leaves the expert).  Routing is capacity-bounded greedy dispatch, as in
the reference: a (token, j) pair's place in its expert's queue is a
running count over the token-major pairs, and pairs past the capacity
are dropped.

Every step runs on the device with no host sync (a decode step runs
under ``torch.cuda.set_sync_debug_mode("error")``): the capacity is a
Python int from the shapes, queue places come from an integer cumsum,
and there is no boolean indexing, ``nonzero`` or ``.item()``.

Differences from the reference, each deliberate:

- The combine.  The reference scatter-adds the kept slots' weighted
  outputs into the tokens' rows (``.at[tok].add``), visiting slots in
  ascending order.  On the card an ``index_add_`` adds with atomics in no
  fixed order, so bf16 sums (and greedy tokens) would change from run to
  run.  Here each token gathers its k slots, sorted by slot (its experts
  are distinct, so by expert id), and adds them in that order in x's
  dtype: the reference's order, and deterministic.  A dropped pair adds
  an exact zero.
- Training differentiates this same path: the weights through top-k,
  the gathers and the combine (a dropped pair's weight gets a zero
  gradient, as the reference's dump slot gives it), and the aux loss
  through the router's probabilities (its expert counts are integers,
  as the reference's one-hot is constant).  The backward of a gather
  adds with atomics on the card, so gradients need not be bitwise
  repeatable there; the forward stays so.

Expert parallelism (the reference's ``shard_map`` over the ``model``
axis): experts shard over ``model``, each rank dispatches its block of
tokens (the reference's batch sharding of the (B*S) tokens) to its own
``E_pad/ep`` experts at ``e_off``, with the per-shard capacity rounded up
to a multiple of 8 as the reference rounds it, and one all-reduce SUM
over ``model`` brings each rank every (token, j) pair's weighted output:
a pair's term is non-zero on the rank of its expert only, so the sum is
exact, and every rank then combines a token's terms in one device's
order and dtype.  The reference psums each rank's combined (T, d)
instead; in bf16 that rounds each rank's share before the sum, and the
routing of the next layers flips at near-ties.  So (T, k, d) crosses,
k times the bytes of the reference's Fsum.  Under a mesh without EP
every rank dispatches every token, as the reference's global dispatch
does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import batch_pspec_entry, psum_matmul
from repro_torch.models.params import Spec


def moe_table(cfg) -> dict:
    m = cfg.moe
    E = m.padded_experts
    d = cfg.d_model
    t = {
        "router": Spec((d, E), ("embed", None), "normal:0.02"),
        "wi_gate": Spec((E, d, m.d_ff_expert), ("experts", "embed", "expert_ffn")),
        "wi_up": Spec((E, d, m.d_ff_expert), ("experts", "embed", "expert_ffn")),
        "wo": Spec((E, m.d_ff_expert, d), ("experts", "expert_ffn", "embed")),
    }
    if m.num_shared_experts:
        t["shared"] = {
            "wi_gate": Spec((d, m.d_ff_shared), ("embed", "ffn")),
            "wi_up": Spec((d, m.d_ff_shared), ("embed", "ffn")),
            "wo": Spec((m.d_ff_shared, d), ("ffn", "embed")),
            "gate": Spec((d, 1), ("embed", None), "zeros"),
        }
    return t


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg,
           tok_entry: shd.Entry = None):
    """Router logits -> (weights (T, k) in x's dtype, ids (T, k), aux).
    Scores are fp32; padded experts are masked with -inf before the
    softmax, then top-k and renormalisation.

    On a mesh whose ranks route the blocks of the tokens sharded over
    ``tok_entry``, each expert's pair count and probability sum are
    psummed over those axes before the aux loss, which then covers every
    token of the global batch, as the reference's (GSPMD) does."""
    m = cfg.moe
    E, Ep = m.num_experts, m.padded_experts
    logits = x2d.float() @ router.float()
    if Ep > E:
        real = torch.arange(Ep, device=x2d.device) < E
        logits = logits.masked_fill(~real, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, m.top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    # load-balancing aux loss (Switch-style) over real experts
    hits = ids[..., None] == torch.arange(Ep, device=x2d.device)
    if tok_entry is None:
        density = hits.float().mean(dim=(0, 1))[:E]
        mean_prob = probs[:, :E].mean(dim=0)
    else:
        T = x2d.shape[0] * shd.entry_index(tok_entry)[1]
        density = shd.psum(hits.float().sum(dim=(0, 1))[:E],
                           tok_entry) / (T * m.top_k)
        mean_prob = shd.psum(probs[:, :E].sum(dim=0), tok_entry) / T
    aux = E * torch.sum(density * mean_prob)
    return w.to(x2d.dtype), ids, aux


def _expert_compute(xbuf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wo: torch.Tensor) -> torch.Tensor:
    """xbuf: (E, C, d) -> (E, C, d) through SwiGLU experts, the silu in
    fp32 cast back."""
    g = torch.bmm(xbuf, wg)
    u = torch.bmm(xbuf, wu)
    h = F.silu(g.float()).to(xbuf.dtype) * u
    return torch.bmm(h, wo)


def dispatch(ids: torch.Tensor, Ep: int,
             capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, j) pair's capacity slot -> (slot (T, k), keep (T, k)).
    A pair's place in its expert's queue counts the pairs before it in
    the token-major order ``ids.reshape(T * k)`` that chose the same
    expert; a pair at or past ``capacity`` is dropped, and its slot is
    the dump slot ``Ep * capacity``."""
    T, k = ids.shape
    fid = ids.reshape(T * k)
    # (Ep, T * k): the running count runs along the contiguous last axis
    # (a scan down the outer axis of a (T * k, Ep) one-hot is many times
    # slower on the card at prefill sizes)
    onehot = (torch.arange(Ep, device=ids.device)[:, None] == fid).to(
        torch.int32)
    pos = (torch.cumsum(onehot, dim=1, dtype=torch.int32)
           * onehot).sum(0) - 1
    keep = pos < capacity
    slot = torch.where(keep, fid * capacity + pos.clamp(0, capacity - 1),
                       Ep * capacity)
    return slot.reshape(T, k), keep.reshape(T, k)


def _moe_local(x2d: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
               wg: torch.Tensor, wu: torch.Tensor, wo: torch.Tensor, *,
               capacity: int, cfg, e_off: int = 0,
               axis: shd.Entry = None) -> torch.Tensor:
    """Dispatch the tokens to the capacity buffers of the experts
    [e_off, e_off + E) that ``wg``/``wu``/``wo`` hold (E = their leading
    dim; all of them with no mesh), compute, and combine each token's
    kept slots in ascending slot order.  Under EP (``axis``, the experts'
    mesh axis) each pair's weighted output is summed over the axis
    first, so that every rank combines every expert's terms."""
    T, d = x2d.shape
    E = wg.shape[0]
    C = capacity
    slot, keep = dispatch(ids, cfg.moe.padded_experts, C)
    # the combine's order: a token's slots ascending, as the reference's
    # scatter-add visits them; taken before the slots turn local, so that
    # every rank of EP has the same order
    slot, order = torch.sort(slot, dim=-1)
    keep, ids, w = (t.gather(-1, order) for t in (keep, ids, w))
    if E != cfg.moe.padded_experts:       # a rank's experts under EP
        keep = keep & (ids >= e_off) & (ids < e_off + E)
        slot = torch.where(keep, slot - e_off * C, E * C)
    tok = torch.arange(T, device=x2d.device)[:, None].expand_as(slot)
    # scatter scalar token ids into slots, then gather rows once: an
    # empty slot (and the dump slot) holds token T, a zero row
    tok_of = torch.full((E * C + 1,), T, dtype=torch.int64,
                        device=x2d.device)
    tok_of.index_put_((slot.reshape(-1),), tok.reshape(-1))
    xpad = torch.cat([x2d, x2d.new_zeros(1, d)])
    xbuf = xpad[tok_of[:E * C]].reshape(E, C, d)
    out = _expert_compute(xbuf, wg, wu, wo).reshape(E * C, d)
    out = torch.cat([out, out.new_zeros(1, d)])
    # a dropped pair (and another rank's) adds an exact zero
    wk = torch.where(keep, w, torch.zeros_like(w))
    terms = [out[slot[:, j]] * wk[:, j:j + 1] for j in range(slot.shape[1])]
    if axis is not None:
        terms = shd.psum(torch.stack(terms, 1), axis).unbind(1)
    y = terms[0]
    for t in terms[1:]:
        y = y + t
    return y


def moe_apply(p: dict, x: torch.Tensor, cfg, *,
              capacity_factor: Optional[float] = None,
              batch_entry: shd.Entry = None, train: bool = False):
    """MoE FFN. x: (B, S, d) (or (B, 1, d) decode). Returns (y, aux).

    The capacity uses the real expert count (the padded experts are
    never routed to, but keep their slots in the buffer, as in the
    reference): ``max(8, int(T * top_k / num_experts * capacity_factor))``.

    Under a DeviceMesh ``x`` is this rank's block of the batch, sharded
    over the mesh axes ``batch_entry`` (None: the whole batch), and ``y``
    the same block.  With ``train`` (the loss) ``aux`` covers every
    token of the global batch (the experts' counts and probability sums
    psummed over the ranks that route the token blocks), the same value
    on every rank; serving discards ``aux`` and skips those psums, so
    there it covers the tokens this rank routed.
    """
    B, S, d = x.shape
    m = cfg.moe
    if capacity_factor is None:
        capacity_factor = m.capacity_factor
    if shd.device_mesh() is not None:
        return _moe_mesh(p, x, cfg, capacity_factor, batch_entry, train)
    x2d = x.reshape(B * S, d)
    w, ids, aux = _route(x2d, p["router"], cfg)
    cap = max(8, int((B * S * m.top_k / m.num_experts) * capacity_factor))
    y = _moe_local(x2d, w, ids, p["wi_gate"], p["wi_up"], p["wo"],
                   capacity=cap, cfg=cfg)
    if m.num_shared_experts:
        y = y + _shared(p["shared"], x2d, y.dtype, mesh=False)
    return y.reshape(B, S, d), aux


def _shared(s: dict, x2d: torch.Tensor, dtype: torch.dtype,
            mesh: bool) -> torch.Tensor:
    """The shared expert's gated output; on a mesh its ``ffn`` dim is
    tensor-parallel (this rank's columns, then a psum in fp32:
    ``layers.psum_matmul``)."""
    if mesh:
        fspec = shd.spec(s["wi_gate"], "embed", "ffn")[1]
        s = {"wi_gate": shd.local(s["wi_gate"], "embed", "ffn"),
             "wi_up": shd.local(s["wi_up"], "embed", "ffn"),
             "wo": shd.local(s["wo"], "ffn", "embed"),
             "gate": shd.local(s["gate"], "embed", None)}
    g = x2d @ s["wi_gate"]
    u = x2d @ s["wi_up"]
    h = F.silu(g.float()).to(x2d.dtype) * u
    sh = psum_matmul(h, s["wo"], fspec) if mesh else h @ s["wo"]
    gate = torch.sigmoid(x2d.float() @ s["gate"].float())
    return sh * gate.to(dtype)


def _reblock(t: torch.Tensor, src: shd.Entry, dst: shd.Entry) -> torch.Tensor:
    """Rows sharded over ``src`` -> the same rows' block over ``dst``."""
    if src == dst:
        return t
    t = shd.all_gather(t, src, 0)
    i, n = shd.entry_index(dst)
    step = t.shape[0] // n
    return t.narrow(0, i * step, step)


def _moe_mesh(p: dict, x: torch.Tensor, cfg, capacity_factor: float,
              batch_entry: shd.Entry, train: bool = False):
    """The mesh branch: expert parallelism over ``model`` when the
    experts rule maps there and the padded experts divide it, else every
    rank dispatches every token to every expert."""
    B, S, d = x.shape
    m = cfg.moe
    mesh = shd.device_mesh()
    ep = shd.axis_size("model")
    use_ep = (ep > 1 and shd.resolve(("experts",)) == ("model",)
              and m.padded_experts % ep == 0)
    T_tok = B * S * shd.entry_index(batch_entry)[1]
    # the tokens this rank dispatches: the reference shards the (B*S)
    # tokens over the batch axes that divide them, for EP's shard_map;
    # without EP its dispatch is global
    tok_entry = batch_pspec_entry(T_tok, mesh) if use_ep else None
    x2d = _reblock(x.reshape(B * S, d), batch_entry, tok_entry)
    w, ids, aux = _route(x2d, shd.local(p["router"], "embed", None), cfg,
                         tok_entry if train else None)
    names = ("experts", None, None)
    wg, wu, wo = (shd.local(p[k], *names) for k in ("wi_gate", "wi_up", "wo"))
    t_loc = x2d.shape[0]
    if use_ep:
        cap = max(8, int((t_loc * m.top_k / m.num_experts) * capacity_factor))
        cap = -(-cap // 8) * 8
        e_off = shd.entry_index("model")[0] * wg.shape[0]
        y = _moe_local(x2d, w, ids, wg, wu, wo, capacity=cap, cfg=cfg,
                       e_off=e_off, axis="model")
    else:
        cap = max(8, int((t_loc * m.top_k / m.num_experts) * capacity_factor))
        y = _moe_local(x2d, w, ids, wg, wu, wo, capacity=cap, cfg=cfg)
    y = _reblock(y, tok_entry, batch_entry)
    if m.num_shared_experts:
        x2d = x.reshape(B * S, d)
        y = y + _shared(p["shared"], x2d, y.dtype, mesh=True)
    return y.reshape(B, S, d), aux
