"""Public wrappers for the port's kernels: the counterparts of
``repro/kernels/ops.py``'s embedding-bag, flash-attention and
flash-decode entries, with the reference's signatures and layouts.

Dispatch is by where the tensors lie.  For CPU tensors a wrapper runs
the kernel's plain PyTorch version; for CUDA tensors it launches the
hand-written kernel or raises, never falling back.  ``LAUNCHES`` counts
each kernel's launches (and nothing else), so a run can show that its
main path went through the kernels.

The CUDA kernels have no backward: each writes its output through
ctypes, so the result carries no autograd graph.  A CUDA branch
therefore refuses operands that require grad while grad mode is on
(:func:`refuse_grad`) rather than drop their gradients without a word.
Training takes the reference's differentiable path instead
(``models.layers.flash_attention_blocked``, ``kernels.ref.embedding_bag_ref``),
as the reference never differentiates its Pallas kernels.  The CPU
branch, the plain versions, stays differentiable.

No DTensor reaches a kernel: on a mesh the models call every kernel on a
rank's local blocks (``distributed.sharding.local``), and every wrapper
refuses a DTensor operand (:func:`refuse_dtensor`), on either device,
rather than hand its sharded storage to a kernel (or its plain version)
as if it were the whole tensor.

Fake operands (``FakeTensor``, the dry run's ``launch.dryrun``) stand
for the kernel's operands on the card and take a path of their own
before the dispatch by device: no launch, fake outputs of exactly the
kernel's shapes and dtypes, the call counted in ``FAKE_LAUNCHES`` (never
in ``LAUNCHES``) and its work, from the operands' shapes
(:func:`kernel_cost`), added to ``FAKE_COST``.  Only a ``FakeTensor``
reaches it, on whatever device it says it lies (``cuda:0`` where
PyTorch has CUDA; the CPU where it has not, since a fake CUDA tensor
there can be neither indexed nor differentiated): a real CUDA tensor
launches the kernel or raises, a real CPU tensor takes the plain
version, and a meta tensor falls to the launch, which refuses it, as
before.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"embedding_bag": 0,
                            "embedding_bag_fused_flat": 0,
                            "embedding_bag_nmp_flat": 0,
                            "flash_attention": 0,
                            "flash_decode_partial": 0}
#: kernel name -> calls on fake operands since the last reset (no launch)
FAKE_LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
#: kernel name -> [flops, bytes] of those calls (:func:`kernel_cost`)
FAKE_COST: Dict[str, List[int]] = {k: [0, 0] for k in LAUNCHES}


def refuse_grad(kernel: str, *operands) -> None:
    """Raise when grad mode is on and an operand requires grad: the CUDA
    ``kernel`` would return a result with no autograd graph."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in operands):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward and would drop the "
            f"gradients of its operands; training takes the reference's "
            f"differentiable path (models.layers.flash_attention_blocked, "
            f"kernels.ref.embedding_bag_ref), or call the kernel under "
            f"torch.no_grad()")


def refuse_dtensor(kernel: str, *operands) -> None:
    """Raise when an operand is a DTensor: a kernel takes a rank's local
    blocks (``DTensor.to_local()``), never the sharded whole."""
    if any(isinstance(t, DTensor) for t in operands):
        raise TypeError(
            f"{kernel}: a DTensor operand; kernels run on a rank's local "
            f"blocks (distributed.sharding.local, DTensor.to_local())")


def reset_launches() -> None:
    """Zero ``LAUNCHES``, the attention kernels' per-variant counts
    (``flash_attention.VARIANT_LAUNCHES``) and the fake calls' tally."""
    for counts in (LAUNCHES, _fa.VARIANT_LAUNCHES):
        for name in counts:
            counts[name] = 0
    reset_fake()


def reset_fake() -> None:
    """Zero the fake calls' tally (``FAKE_LAUNCHES``, ``FAKE_COST``) and
    nothing else: the dry run leaves ``LAUNCHES`` as it found it."""
    for name in FAKE_LAUNCHES:
        FAKE_LAUNCHES[name] = 0
        FAKE_COST[name] = [0, 0]


def _attention_pairs(S: int, T: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps: sum over i < S of
    min(i + 1, T) when causal, else S * T."""
    if not causal:
        return S * T
    n = min(S, T)
    return n * (n + 1) // 2 + (S - n) * T


def kernel_cost(name: str, *operands, causal: bool = True,
                live: Optional[int] = None):
    """(flops, bytes) of one call of kernel ``name`` from its operands'
    shapes: the one definition of the kernels' work, for the dry run's
    costs and for the bounds of ``chip_smoke.py``'s kernel rows.
    Attention: 4 B H D over the pairs the mask keeps, q, k, v read and o
    written once.  Decode: 4 B H D over the ``live`` cache rows (those up
    to the device ``pos``; None: every row, all that shapes tell), those
    rows of K and V, q and the fp32 partials once.  A bag: D adds per
    ``live`` valid slot (None: every slot, -1 padding unknown), those
    rows, the indices (and the flat bags' offsets) and the pooled output
    once.  Operands: (q, k) for attention, (q, k_cache) for decode,
    (table, idx) for the bags."""
    if name == "flash_attention":
        q, k = operands
        B, H, S, D = q.shape
        Hkv, T = k.shape[1], k.shape[2]
        return (4 * B * H * D * _attention_pairs(S, T, causal),
                (2 * B * H * S * D + 2 * B * Hkv * T * D) * q.element_size())
    if name == "flash_decode_partial":
        q, kc = operands
        B, H, D = q.shape
        Hkv = kc.shape[2]
        n = kc.shape[1] if live is None else live
        return (4 * B * H * D * n,
                2 * B * n * Hkv * D * kc.element_size()
                + B * H * D * q.element_size() + B * H * (D + 2) * 4)
    table, idx = operands
    B, T, P = idx.shape
    D = table.shape[-1]
    slots = B * T * P if live is None else live
    stacked = name == "embedding_bag"
    out = table.element_size() if stacked else 4
    return (slots * D,
            slots * D * table.element_size() + B * T * P * 4
            + B * T * D * out + (0 if stacked else T * 4))


def is_fake(*operands) -> bool:
    """Whether an operand is a ``FakeTensor`` (no storage to launch on)."""
    return any(isinstance(t, FakeTensor) for t in operands)


def _fake_call(name: str, cost, out):
    """Count a fake call of ``name`` and its work; return ``out``."""
    FAKE_LAUNCHES[name] += 1
    FAKE_COST[name][0] += cost[0]
    FAKE_COST[name][1] += cost[1]
    return out


def embedding_bag(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The table-stack bag (the reference's ``embedding_bag``): tables
    (T, R, D), idx (B, T, P) int32 -1 padded -> pooled (B, T, D) in the
    tables' dtype, one launch for the whole stack.  A row past its
    table's end reads that table's last row."""
    refuse_dtensor("embedding_bag", tables, idx)
    if is_fake(tables, idx):
        refuse_grad("embedding_bag", tables)
        B, T, _ = idx.shape
        return _fake_call("embedding_bag", kernel_cost(
            "embedding_bag", tables, idx), tables.new_empty(
                (B, T, tables.shape[-1])))
    if tables.device.type == "cpu":
        return _eb.embedding_bag_stacked_plain(tables, idx)
    refuse_grad("embedding_bag", tables)
    out = _eb.embedding_bag_stacked(tables, idx)
    LAUNCHES["embedding_bag"] += 1
    return out


def _fake_flat(name: str, flat_table: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    B, T, _ = idx.shape
    return _fake_call(name, kernel_cost(name, flat_table, idx),
                      flat_table.new_empty((B, T, flat_table.shape[1]),
                                           dtype=torch.float32))


def embedding_bag_fused_flat(flat_table: torch.Tensor, offsets: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """CN-side pooling of a flat shard: (sum_t R_t, D), offsets (T,)
    int32, idx (B, T, P) int32 -1 padded -> pooled (B, T, D) fp32."""
    refuse_dtensor("embedding_bag_fused_flat", flat_table, offsets, idx)
    if is_fake(flat_table, offsets, idx):
        refuse_grad("embedding_bag_fused_flat", flat_table)
        return _fake_flat("embedding_bag_fused_flat", flat_table, idx)
    if flat_table.device.type == "cpu":
        return _eb.embedding_bag_flat_plain(flat_table, offsets, idx)
    refuse_grad("embedding_bag_fused_flat", flat_table)
    out = _eb.embedding_bag_fused_flat(flat_table, offsets, idx)
    LAUNCHES["embedding_bag_fused_flat"] += 1
    return out


def embedding_bag_nmp_flat(flat_table: torch.Tensor, offsets: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """On-MN (near-memory) pooling: same contract and bits as
    :func:`embedding_bag_fused_flat`, table-major execution."""
    refuse_dtensor("embedding_bag_nmp_flat", flat_table, offsets, idx)
    if is_fake(flat_table, offsets, idx):
        refuse_grad("embedding_bag_nmp_flat", flat_table)
        return _fake_flat("embedding_bag_nmp_flat", flat_table, idx)
    if flat_table.device.type == "cpu":
        return _eb.embedding_bag_flat_plain(flat_table, offsets, idx)
    refuse_grad("embedding_bag_nmp_flat", flat_table)
    out = _eb.embedding_bag_nmp_flat(flat_table, offsets, idx)
    LAUNCHES["embedding_bag_nmp_flat"] += 1
    return out


def _table_offsets(tables: torch.Tensor) -> torch.Tensor:
    T, R, _ = tables.shape
    if T * R > torch.iinfo(torch.int32).max:
        raise ValueError(f"{T} tables of {R} rows exceed the kernels' "
                         f"int32 row offsets")
    return torch.arange(T, dtype=torch.int32, device=tables.device) * R


def embedding_bag_fused(tables: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """tables (T, R, D); idx (B, T, P) -> pooled (B, T, D) in the
    tables' dtype, through the fused flat kernel."""
    T, R, D = tables.shape
    out = embedding_bag_fused_flat(tables.reshape(T * R, D),
                                   _table_offsets(tables), idx)
    return out.to(tables.dtype)


def embedding_bag_nmp(tables: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """tables (T, R, D); idx (B, T, P) -> pooled (B, T, D) in the
    tables' dtype, through the near-memory flat kernel."""
    T, R, D = tables.shape
    out = embedding_bag_nmp_flat(tables.reshape(T * R, D),
                                 _table_offsets(tables), idx)
    return out.to(tables.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_block: int = 128,
                    kv_block: int = 128) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, Hkv, T, D) -> (B, H, S, D) in q's dtype.
    The block sizes shape the plain version only: the kernels pick their
    own tiles (``flash_attention.variant`` says which kernel runs)."""
    refuse_dtensor("flash_attention", q, k, v)
    if is_fake(q, k, v):
        refuse_grad("flash_attention", q, k, v)
        return _fake_call("flash_attention",
                          kernel_cost("flash_attention", q, k, causal=causal),
                          torch.empty_like(q))
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         q_block=q_block, kv_block=kv_block)
    refuse_grad("flash_attention", q, k, v)
    out = _fa.flash_attention(q, k, v, causal=causal)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos, kv_offset: int = 0,
                         kv_block: int = 256):
    """q (B, H, D); caches (B, T, Hkv, D); pos a scalar (an int32 device
    tensor on the serving path) -> fp32 partials (o (B, H, D)
    unnormalised, l (B, H), m (B, H)) for ``layers.combine_partials``.
    ``kv_block`` shapes the plain version only.  On the card one call is
    one launch in ``LAUNCHES`` but may be two device kernels: the
    split-KV kernel, then the merge of its splits."""
    refuse_dtensor("flash_decode_partial", q, k_cache, v_cache, pos)
    if is_fake(q, k_cache, v_cache, pos):
        refuse_grad("flash_decode_partial", q, k_cache, v_cache)
        B, H, D = q.shape
        f32 = dict(dtype=torch.float32)
        return _fake_call("flash_decode_partial",
                          kernel_cost("flash_decode_partial", q, k_cache),
                          (q.new_empty((B, H, D), **f32),
                           q.new_empty((B, H), **f32),
                           q.new_empty((B, H), **f32)))
    if q.device.type == "cpu":
        return _fd.flash_decode_plain(q, k_cache, v_cache, pos,
                                      kv_offset=kv_offset, kv_block=kv_block)
    refuse_grad("flash_decode_partial", q, k_cache, v_cache)
    out = _fd.flash_decode_partial(q, k_cache, v_cache, pos,
                                   kv_offset=kv_offset)
    LAUNCHES["flash_decode_partial"] += 1
    return out
