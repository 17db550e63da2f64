"""Flash-decode partials: a CUDA kernel for Hopper and its plain PyTorch
version.

``flash_decode_partial`` (CUDA ``fd_partial``, ``csrc/flash_decode.cu``)
    Replaces ``repro/kernels/flash_decode.py:flash_decode_partial``, the
    Pallas kernel of one decode step's attention.  q ``(B, H, D)``, caches
    ``(B, T, Hkv, D)``, a scalar ``pos`` and the slice's ``kv_offset`` ->
    unnormalised ``o (B, H, D)`` and ``l, m (B, H)``, all fp32, over the
    cache rows at or before ``pos``.  ``m`` starts at ``-1e30`` and rows
    past ``pos`` add nothing, so a slice wholly after ``pos`` gives
    ``m = -1e30``, ``l = 0`` and ``o = 0`` (where
    ``layers.decode_attention_local`` of the reference gives
    ``m = -inf``).

Bound on the card: bytes, the cache rows up to ``pos`` read once
(6.7 MB at smollm-135m's decode with B=8 and pos 1087: 0.002 ms).  The
kernel splits the cache across CTAs (split-KV): a grid of
``(splits, Hkv, B)``, ``splits`` from :func:`num_splits` (B * Hkv, T
and the SM count, never ``pos``), each CTA cutting its share of the
live rows from ``pos`` on the device and reading them with 16-byte
loads; the G query heads
of a kv head share each K/V row read.  With more than one split a
second kernel merges the splits' partials from an fp32 workspace in
split order, so the result is deterministic.  The source says more.

``pos`` stays on the device: the wrapper takes it as an int32 tensor and
the kernel reads it there, so a decode step makes no host sync for it.
``kv_block`` shapes only the plain version's blocking, and the results
do not depend on it.

The functions here launch unconditionally; ``kernels.ops`` is the public
entry that picks the plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple, Union

import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import NEG_INF

#: largest G * D the kernel takes (its query heads run in passes of 4)
MAX_GROUP_WIDTH = 2048
#: CTAs per SM the split count aims at: two waves of the card
WAVES = 2
#: fewest cache rows per split, and most splits
MIN_SPLIT_ROWS, MAX_SPLITS = 32, 16
_SOURCE = "flash_decode"
_ENTRIES = {"fd_partial": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}

Pos = Union[int, torch.Tensor]
Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def as_pos(pos: Pos, device: torch.device) -> torch.Tensor:
    """``pos`` as a one-element int32 tensor on ``device`` (a tensor that
    already lies there is used as it is, with no copy and no sync)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(1)
    return torch.tensor([pos], dtype=torch.int32, device=device)


def num_splits(B: int, Hkv: int, T: int, sm_count: int) -> int:
    """How many CTAs share one (kv head, batch row)'s cache: enough for
    ``WAVES`` CTAs per SM, at least ``MIN_SPLIT_ROWS`` of the T rows
    each and at most ``MAX_SPLITS``.  It depends on the shapes and the
    card alone, never on ``pos``."""
    want = -(-WAVES * sm_count // (B * Hkv))
    return max(1, min(want, -(-T // MIN_SPLIT_ROWS), MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, pos: Pos, kv_offset: int = 0,
                       kv_block: int = 256) -> Partials:
    """Plain PyTorch version: the Pallas kernel's online softmax over
    ``kv_block``-row blocks, in fp32.  A block past ``pos`` leaves the
    running (m, l, acc) as they are, selected on the device rather than
    skipped on the host, so ``pos`` is never read back."""
    B, H, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    kb = min(kv_block, T)
    scale = 1.0 / math.sqrt(D)
    p_now = as_pos(pos, q.device)[0]
    qf = q.float().reshape(B, Hkv, G, D)
    m = torch.full((B, Hkv, G, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, D), device=q.device)
    for k0 in range(0, T, kb):
        k1 = min(k0 + kb, T)
        kf = k_cache[:, k0:k1].float()                   # (B, kb, Hkv, D)
        vf = v_cache[:, k0:k1].float()
        s = torch.einsum("bhgd,bthd->bhgt", qf, kf) * scale
        t = kv_offset + torch.arange(k0, k1, device=q.device)
        s = torch.where(t <= p_now, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        live = kv_offset + k0 <= p_now
        l = torch.where(live, l * corr + p.sum(-1, keepdim=True), l)
        acc = torch.where(live, acc * corr
                          + torch.einsum("bhgt,bthd->bhgd", p, vf), acc)
        m = torch.where(live, m_new, m)
    return (acc.reshape(B, H, D), l.reshape(B, H), m.reshape(B, H))


def _check(q: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor) -> None:
    common.check_attention_operands("decode", q, k_cache=k_cache,
                                    v_cache=v_cache)
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q must be (B, H, D) and the caches (B, T, Hkv, "
                         f"D), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, D = q.shape
    _, T, Hkv, Dc = k_cache.shape
    if k_cache.shape[0] != B or Dc != D or H % Hkv:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}: same B and D, H a multiple "
                         f"of Hkv")
    common.check_head_dim(D)
    if (H // Hkv) * D > MAX_GROUP_WIDTH:
        raise ValueError(f"G * D = {(H // Hkv) * D} exceeds the kernel's "
                         f"{MAX_GROUP_WIDTH}")
    if min(B, T) < 1:
        raise ValueError("the kernel takes non-empty B and T")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the "
                             f"kernel's 16-byte loads")


def flash_decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: Pos,
                         kv_offset: int = 0) -> Partials:
    """Launch the decode kernels on the card -> fp32 (o, l, m): the split
    kernel and, with more than one split, the merge, both on the current
    stream."""
    _check(q, k_cache, v_cache)
    lib = common.bind(_SOURCE, _ENTRIES, "fd_error_string")
    B, H, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    splits = num_splits(B, Hkv, T, _sm_count(q.device.index))
    pos_t = as_pos(pos, q.device)
    o = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    ws = (torch.empty(splits * B * H * (D + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fd_partial(q.data_ptr(), k_cache.data_ptr(),
                         v_cache.data_ptr(), pos_t.data_ptr(), o.data_ptr(),
                         l.data_ptr(), m.data_ptr(),
                         None if ws is None else ws.data_ptr(),
                         common.DTYPE_CODES[q.dtype], B, Hkv, H // Hkv, T, D,
                         int(kv_offset), splits, 1.0 / math.sqrt(D),
                         q.device.index, stream)
    common.raise_on_error(lib, "fd_error_string", "fd_partial", err)
    return o, l, m
