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
"""
from __future__ import annotations

from typing import Dict

import torch
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
    """Zero ``LAUNCHES`` and the attention kernels' per-variant counts
    (``flash_attention.VARIANT_LAUNCHES``)."""
    for counts in (LAUNCHES, _fa.VARIANT_LAUNCHES):
        for name in counts:
            counts[name] = 0


def embedding_bag(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The table-stack bag (the reference's ``embedding_bag``): tables
    (T, R, D), idx (B, T, P) int32 -1 padded -> pooled (B, T, D) in the
    tables' dtype, one launch for the whole stack.  A row past its
    table's end reads that table's last row."""
    refuse_dtensor("embedding_bag", tables, idx)
    if tables.device.type == "cpu":
        return _eb.embedding_bag_stacked_plain(tables, idx)
    refuse_grad("embedding_bag", tables)
    out = _eb.embedding_bag_stacked(tables, idx)
    LAUNCHES["embedding_bag"] += 1
    return out


def embedding_bag_fused_flat(flat_table: torch.Tensor, offsets: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """CN-side pooling of a flat shard: (sum_t R_t, D), offsets (T,)
    int32, idx (B, T, P) int32 -1 padded -> pooled (B, T, D) fp32."""
    refuse_dtensor("embedding_bag_fused_flat", flat_table, offsets, idx)
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
    if q.device.type == "cpu":
        return _fd.flash_decode_plain(q, k_cache, v_cache, pos,
                                      kv_offset=kv_offset, kv_block=kv_block)
    refuse_grad("flash_decode_partial", q, k_cache, v_cache)
    out = _fd.flash_decode_partial(q, k_cache, v_cache, pos,
                                   kv_offset=kv_offset)
    LAUNCHES["flash_decode_partial"] += 1
    return out
