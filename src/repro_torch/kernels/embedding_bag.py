"""Embedding-bag (gather + pooling) kernels: CUDA for Hopper, plain
PyTorch beside them.

Both kernels take a flat shard ``(sum_t R_t, D)`` (fp32 or bf16), the
row offset of each routed table in it ``(T,)`` int32 (any order: the
cluster passes ``slot * R`` for a shard's routed subset), and table-
local indices ``(B, T, P)`` int32, -1 padded.  They return the pooled
``(B, T, D)`` in fp32, slots added in ascending order into an fp32
accumulator that starts at zero, padding slots skipped.  So the fp32
output is bitwise equal between the two kernels and to
:func:`embedding_bag_flat_plain`, the plain version of both.

``embedding_bag_fused_flat`` (CUDA ``eb_fused_flat``)
    Replaces ``repro/kernels/embedding_bag.py:embedding_bag_fused_flat``,
    the CN-side bag that pools a DDR memory node's raw rows.  One warp
    per (b, t) bag.
``embedding_bag_nmp_flat`` (CUDA ``eb_nmp_flat``)
    Replaces ``repro/kernels/embedding_bag.py:embedding_bag_nmp_flat``,
    the near-memory pooling of an NMP memory node.  Table-major like the
    node: one block per table, whose warps stride over the batch.

Bound on the card: bytes, ``valid_slots * D * itemsize + B*T*P*4 +
B*T*D*4`` over the memory rate (3.35 TB/s on an H100 SXM); the adds are
negligible.  The rows are gathered at random, so the design reads each
byte once: a row goes from device memory into registers in 16-byte
vector loads where ``D % 4 == 0``, is added there, and never touches
shared memory; no atomics (they would break the add order); each warp
fetches its bag's next 32 indices in one load and shares them by
shuffle.  Row addresses are 64-bit (a full-width shard has more than
2^31 elements).  ``csrc/embedding_bag.cu`` holds the kernels.

The functions here launch unconditionally; ``kernels.ops`` is the public
entry that picks the plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: widest row the kernels' register accumulators hold
MAX_D = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "embedding_bag"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def embedding_bag_flat_plain(flat_table: torch.Tensor, offsets: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of both kernels: gather every slot's row,
    zero the padding slots, and add the slots in ascending order into an
    fp32 accumulator -> pooled (B, T, D) fp32."""
    B, T, P = idx.shape
    valid = (idx >= 0).unsqueeze(-1)                          # (B,T,P,1)
    rows = (offsets.to(torch.int64)[None, :, None]
            + idx.clamp(min=0).to(torch.int64))               # (B,T,P)
    gathered = flat_table[rows].to(torch.float32)             # (B,T,P,D)
    gathered = torch.where(valid, gathered, 0.0)
    acc = torch.zeros((B, T, flat_table.shape[1]), dtype=torch.float32,
                      device=flat_table.device)
    for p in range(P):
        acc = acc + gathered[:, :, p]
    return acc


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    for fn in (lib.eb_fused_flat, lib.eb_nmp_flat):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.eb_error_string.argtypes = [ctypes.c_int]
    lib.eb_error_string.restype = ctypes.c_char_p
    return lib


def _check(flat_table: torch.Tensor, offsets: torch.Tensor,
           idx: torch.Tensor) -> None:
    dev = flat_table.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA bag kernels take CUDA tensors, got a "
                         f"table on {dev}")
    for name, t in (("offsets", offsets), ("idx", idx)):
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, the table on "
                             f"{dev}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if flat_table.dtype not in _DTYPE_CODES:
        raise ValueError(f"table dtype {flat_table.dtype} is not one of "
                         f"{sorted(map(str, _DTYPE_CODES))}")
    if flat_table.dim() != 2 or not flat_table.is_contiguous():
        raise ValueError("the table must be a contiguous (rows, D) matrix")
    if idx.dim() != 3 or offsets.shape != (idx.shape[1],):
        raise ValueError(f"idx {tuple(idx.shape)} must be (B, T, P) with "
                         f"offsets (T,), got offsets "
                         f"{tuple(offsets.shape)}")
    B, T, _ = idx.shape
    D = flat_table.shape[1]
    if B < 1 or T < 1 or not 1 <= D <= MAX_D:
        raise ValueError(f"the kernels take B >= 1, T >= 1 and "
                         f"1 <= D <= {MAX_D}, got B={B} T={T} D={D}")


def _launch(fn_name: str, flat_table: torch.Tensor, offsets: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    _check(flat_table, offsets, idx)
    lib = _lib()
    B, T, P = idx.shape
    D = flat_table.shape[1]
    out = torch.empty((B, T, D), dtype=torch.float32, device=idx.device)
    vec = (D % 4 == 0
           and flat_table.data_ptr() % (4 * flat_table.element_size()) == 0)
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    err = getattr(lib, fn_name)(
        flat_table.data_ptr(), _DTYPE_CODES[flat_table.dtype],
        flat_table.shape[0], offsets.data_ptr(), idx.data_ptr(),
        out.data_ptr(), B, T, P, D, int(vec), idx.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.eb_error_string(err).decode()}")
    return out


def embedding_bag_fused_flat(flat_table: torch.Tensor, offsets: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """Launch the CN-side fused bag (one warp per bag) on the card."""
    return _launch("eb_fused_flat", flat_table, offsets, idx)


def embedding_bag_nmp_flat(flat_table: torch.Tensor, offsets: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """Launch the table-major near-memory bag on the card."""
    return _launch("eb_nmp_flat", flat_table, offsets, idx)
