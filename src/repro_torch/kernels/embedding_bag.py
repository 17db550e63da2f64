"""Embedding-bag (gather + pooling) kernels: CUDA for Hopper, plain
PyTorch beside them.

The two flat kernels take a flat shard ``(sum_t R_t, D)`` (fp32 or
bf16), the row offset of each routed table in it ``(T,)`` int32 (any
order: the cluster passes ``slot * R`` for a shard's routed subset), and
table-local indices ``(B, T, P)`` int32, -1 padded.  They return the pooled
``(B, T, D)`` in fp32, slots added in ascending order into an fp32
accumulator that starts at zero, padding slots skipped.  So the fp32
output is bitwise equal between the two kernels and to
:func:`embedding_bag_flat_plain`, the plain version of both.

``embedding_bag_fused_flat`` (CUDA ``eb_fused_flat``)
    Replaces ``repro/kernels/embedding_bag.py:embedding_bag_fused_flat``,
    the CN-side bag that pools a DDR memory node's raw rows.  One warp
    per (b, t) bag.
``embedding_bag_nmp_flat`` (CUDA ``eb_nmp_flat``)
    Replaces ``repro/kernels/embedding_bag.py:embedding_bag_nmp_flat``
    (Pallas body ``_nmp_kernel``), the near-memory pooling of an NMP
    memory node.  Bound by bytes like the others.  Its first design, one
    block per table whose warps strode over the batch one row load at a
    time, was latency-bound instead: a chain of about 265 waited-for
    loads a warp at RM1's first NMP launch, too few bytes in flight for
    the memory, 45% of the bound.  Now one warp per (t, b) bag in
    table-major order (bag ``t * B + b``, the node's and the reference's
    (T, B) order), each taking its bag's valid slots K at a time in slot
    order, all K row loads issued before their adds; the kernel is built
    for the float4 columns a lane owns (1, 2, 4, 8 as D reaches 128, 256,
    512, 1024) and for K (8 at D <= 128 fp32 or 256 bf16, down to 2 at D
    1024), so the loads in flight take about 32 registers a lane.  No
    TMA: Hopper's has no gather mode, and a bulk copy per row into shared
    memory costs a barrier round trip per row for data that is added once
    in registers.
``embedding_bag_stacked`` (CUDA ``eb_stacked``)
    Replaces ``repro/kernels/embedding_bag.py:embedding_bag_1table`` as
    ``embedding_bag`` vmaps it over a ``(T, R, D)`` table stack (the
    table-sharded lookup of ``core.sharding``): indices ``(B, T, P)``
    int32, -1 padded, the pooled ``(B, T, D)`` in the tables' dtype, the
    whole stack in one launch, one warp per (b, t) bag.  Slots add in
    ascending order into fp32 as above, and the sum is rounded once
    (nearest-even), so fp32 is bitwise equal to
    :func:`embedding_bag_stacked_plain` and bf16 equals its fp32 sum cast
    to bf16.  A row past its table's end reads that table's last row.

Bound on the card: bytes, ``valid_slots * D * itemsize + B*T*P*4 +
B*T*D * out_itemsize`` over the memory rate (3.35 TB/s on an H100 SXM;
``out_itemsize`` is 4 for the flat kernels, the tables' for the stacked
one); the adds are negligible.  The rows are gathered at random, so
the design reads each byte once: a row goes from device memory into
registers in 16-byte vector loads where ``D % 4 == 0``, is added there,
and never touches shared memory; no atomics (they would break the add
order); each warp fetches its bag's next 32 indices in one load and
shares them by shuffle.  Row addresses are 64-bit (a full-width shard
or stack has more than 2^31 elements); a row past the table's end reads
its last row, as in the reference.  ``csrc/embedding_bag.cu`` holds the
kernels.

The functions here launch unconditionally; ``kernels.ops`` is the public
entry that picks the plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

#: widest row the kernels' register accumulators hold
MAX_D = 1024
_SOURCE = "embedding_bag"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_STACKED_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ENTRIES = {"eb_fused_flat": _ARGTYPES, "eb_nmp_flat": _ARGTYPES,
            "eb_stacked": _STACKED_ARGTYPES}


def _slot_sum(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """rows (B, T, P, D) and valid (B, T, P, 1) -> the valid slots added
    in ascending order into an fp32 accumulator that starts at zero, as
    every bag kernel adds them: (B, T, D) fp32."""
    gathered = torch.where(valid, rows.to(torch.float32), 0.0)
    acc = torch.zeros(rows.shape[:2] + rows.shape[3:], dtype=torch.float32,
                      device=rows.device)
    for p in range(rows.shape[2]):
        acc = acc + gathered[:, :, p]
    return acc


def embedding_bag_flat_plain(flat_table: torch.Tensor, offsets: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the two flat kernels: gather every slot's row,
    zero the padding slots, and add the slots in ascending order into an
    fp32 accumulator -> pooled (B, T, D) fp32.  A row past either end of
    the flat table reads the nearest end row, as the reference's Pallas
    kernels do (they clamp the block index)."""
    rows = (offsets.to(torch.int64)[None, :, None]
            + idx.clamp(min=0).to(torch.int64))               # (B,T,P)
    rows = rows.clamp(0, flat_table.shape[0] - 1)
    return _slot_sum(flat_table[rows], (idx >= 0).unsqueeze(-1))


def embedding_bag_stacked_sum(tables: torch.Tensor,
                              idx: torch.Tensor) -> torch.Tensor:
    """The stacked kernel's fp32 sums before the final rounding: tables
    (T, R, D), idx (B, T, P) -> (B, T, D) fp32, each slot reading row
    min(idx, R - 1) of its own table (the reference's kernel clamps its
    block index per table), padding skipped, slots added in order."""
    T, R, _ = tables.shape
    tix = torch.arange(T, device=tables.device)[None, :, None]
    rows = idx.clamp(0, R - 1).to(torch.int64)
    return _slot_sum(tables[tix, rows], (idx >= 0).unsqueeze(-1))


def embedding_bag_stacked_plain(tables: torch.Tensor,
                                idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the stacked kernel: gather, clamp per
    table and add in slot order into fp32, then round once to the tables'
    dtype -> pooled (B, T, D)."""
    return embedding_bag_stacked_sum(tables, idx).to(tables.dtype)


def _check_common(table: torch.Tensor, **ints: torch.Tensor) -> None:
    """The table and its int32 operands: CUDA tensors on one device, a
    dtype the kernels take, contiguous."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA bag kernels take CUDA tensors, got a "
                         f"table on {dev}")
    for name, t in ints.items():
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, the table on "
                             f"{dev}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.dtype not in common.DTYPE_CODES:
        raise ValueError(f"table dtype {table.dtype} is not one of "
                         f"{sorted(map(str, common.DTYPE_CODES))}")
    if not table.is_contiguous():
        raise ValueError("the table must be contiguous")


def _check_sizes(B: int, T: int, D: int) -> None:
    if B < 1 or T < 1 or not 1 <= D <= MAX_D:
        raise ValueError(f"the kernels take B >= 1, T >= 1 and "
                         f"1 <= D <= {MAX_D}, got B={B} T={T} D={D}")


def _vec(table: torch.Tensor) -> bool:
    """16-byte (fp32) or 8-byte (bf16) loads: D % 4 == 0 and an aligned
    base, so every row is aligned."""
    return (table.shape[-1] % 4 == 0
            and table.data_ptr() % (4 * table.element_size()) == 0)


def _check(flat_table: torch.Tensor, offsets: torch.Tensor,
           idx: torch.Tensor) -> None:
    _check_common(flat_table, offsets=offsets, idx=idx)
    if flat_table.dim() != 2:
        raise ValueError("the table must be a contiguous (rows, D) matrix")
    if idx.dim() != 3 or offsets.shape != (idx.shape[1],):
        raise ValueError(f"idx {tuple(idx.shape)} must be (B, T, P) with "
                         f"offsets (T,), got offsets "
                         f"{tuple(offsets.shape)}")
    _check_sizes(idx.shape[0], idx.shape[1], flat_table.shape[1])


def _launch(fn_name: str, flat_table: torch.Tensor, offsets: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    _check(flat_table, offsets, idx)
    lib = common.bind(_SOURCE, _ENTRIES, "eb_error_string")
    B, T, P = idx.shape
    D = flat_table.shape[1]
    out = torch.empty((B, T, D), dtype=torch.float32, device=idx.device)
    vec = _vec(flat_table)
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    err = getattr(lib, fn_name)(
        flat_table.data_ptr(), common.DTYPE_CODES[flat_table.dtype],
        flat_table.shape[0], offsets.data_ptr(), idx.data_ptr(),
        out.data_ptr(), B, T, P, D, int(vec), idx.device.index, stream)
    common.raise_on_error(lib, "eb_error_string", fn_name, err)
    return out


def embedding_bag_fused_flat(flat_table: torch.Tensor, offsets: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """Launch the CN-side fused bag (one warp per bag) on the card."""
    return _launch("eb_fused_flat", flat_table, offsets, idx)


def embedding_bag_nmp_flat(flat_table: torch.Tensor, offsets: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """Launch the table-major near-memory bag on the card."""
    return _launch("eb_nmp_flat", flat_table, offsets, idx)


def embedding_bag_stacked(tables: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Launch the stacked bag on the card: tables (T, R, D), idx (B, T, P)
    int32 -> pooled (B, T, D) in the tables' dtype, in one launch."""
    _check_common(tables, idx=idx)
    if tables.dim() != 3 or idx.dim() != 3 or idx.shape[1] != tables.shape[0]:
        raise ValueError(f"tables {tuple(tables.shape)} must be (T, R, D) "
                         f"and idx {tuple(idx.shape)} (B, T, P)")
    T, R, D = tables.shape
    B, _, P = idx.shape
    _check_sizes(B, T, D)
    if R < 1:
        raise ValueError("the tables must have at least one row")
    lib = common.bind(_SOURCE, _ENTRIES, "eb_error_string")
    out = torch.empty((B, T, D), dtype=tables.dtype, device=idx.device)
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    err = lib.eb_stacked(
        tables.data_ptr(), common.DTYPE_CODES[tables.dtype], R,
        idx.data_ptr(), out.data_ptr(), B, T, P, D, int(_vec(tables)),
        idx.device.index, stream)
    common.raise_on_error(lib, "eb_error_string", "eb_stacked", err)
    return out
