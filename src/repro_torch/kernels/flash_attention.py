"""Flash-attention forward: two CUDA kernels for Hopper and their plain
PyTorch version.

``flash_attention`` (``csrc/flash_attention.cu``)
    Replaces ``repro/kernels/flash_attention.py:flash_attention`` (line
    63), the Pallas kernel of the prefill attention.  q ``(B, H, S, D)``,
    k and v ``(B, Hkv, T, D)`` -> o ``(B, H, S, D)`` in q's dtype and
    strides: online softmax with m and l in fp32, scale ``1/sqrt(D)``,
    causal mask ``q_pos >= k_pos`` with positions counted from 0 on both
    axes, masked logits ``-1e30``, key tiles wholly above the diagonal
    skipped, ``o = acc / max(l, 1e-37)``, and GQA through ``h // G``.

Bound on the card: operations.  Causal prefill does
``4 * B * H * D * S (S + 1) / 2`` flops on ``2 * (B H S D + B Hkv T D)``
elements; at smollm-135m's prefill (B=8, S=1024, H=9, D=64) that is 9.67
GFLOP, 0.0098 ms at the bf16 tensor-core rate.

:func:`variant` picks one of two hand-written kernels by dtype and head
dim, before the launch:

``"wgmma"`` (``fa_forward_wgmma``), bf16 with D in ``WGMMA_HEAD_DIMS``
    The tensor-core kernel: a persistent grid (one CTA per SM) walks the
    128-row q tiles heaviest first; in each CTA two consumer warpgroups
    take 64 rows each and one producer thread streams Q, and K and V in
    64-key tiles through a three-stage ring in shared memory, with TMA
    and mbarriers; ``wgmma`` computes S = Q K^T and O += P V, and the
    softmax runs in registers.  Tensor cores take P in bf16 where the
    Pallas kernel keeps p in fp32, so the kernel splits P = P_hi + P_lo
    into two bf16 terms and runs the P V product on both: 1.5x the tensor
    work, and within ``cases.ATTN_TOL`` where rounding p once is not
    (``tests/test_torch_kernels.py`` emulates both).  TMA reads the
    operands in place through 4-D maps over their own strides, so each
    pointer must be 16-byte aligned and each stride a multiple of 8
    elements; :func:`flash_attention` raises on any other view and never
    copies.  zamba2's D = 112 runs padded to 128 in shared memory only:
    the TMA maps keep the true 112, zero-fill columns 112-127, and the
    kernel stores the columns below D alone.
``"scalar"`` (``fa_forward``), fp32, and bf16 with D in {16, 32}
    One CTA per (64-row q tile, head, batch), K/V tiles staged in shared
    memory as fp32, scalar fp32 FMAs: exact to fp32 rounding, which the
    fp32 copy of a model and its 2e-5 tolerance need; the reduced
    configs' bf16 D of 16 and 32 run here too.

The kernels pick their own tiles, so the ``q_block`` and ``kv_block``
arguments shape only the plain version's blocking.  Each operand may be
a strided view whose last axis is contiguous: ``layers`` hands in
``(B, S, H, D)`` tensors permuted to ``(B, H, S, D)`` and gets its output
in the same layout, with no copy.  ``VARIANT_LAUNCHES`` counts each
kernel's launches, so a run can show which one its main path took.

The functions here launch unconditionally; ``kernels.ops`` is the public
entry that picks the plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import NEG_INF

_SOURCE = "flash_attention"
_ENTRIES = {"fa_forward": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
            "fa_forward_wgmma": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
               ctypes.c_void_p],
            "fa_wgmma_smem_bytes": [ctypes.c_int]}
#: head dims the tensor-core kernel takes (bf16 only; 112 padded to 128)
WGMMA_HEAD_DIMS = (64, 112, 128)
#: kernel variant -> launches since the last ``ops.reset_launches``
VARIANT_LAUNCHES = {"wgmma": 0, "scalar": 0}


def variant(dtype: torch.dtype, D: int) -> str:
    """The kernel that takes operands of ``dtype`` and head dim ``D``."""
    return ("wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS
            else "scalar")


def tma_strides(name: str, t: torch.Tensor) -> list:
    """The (batch, head, row) element strides of a 4-D bf16 operand as the
    tensor-core kernel's TMA maps take them; raises ValueError on a
    pointer or stride that TMA cannot take (16-byte aligned, byte strides
    multiples of 16 below 2^40).  An axis of size 1 is never stepped
    along, so its stride is replaced by the row length."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned, which the "
                         f"tensor-core kernel's TMA loads need")
    out = []
    for size, stride in zip(t.shape[:3], t.stride()[:3]):
        if size == 1:
            stride = t.shape[3]
        if stride <= 0 or (stride * t.element_size()) % 16 \
                or stride * t.element_size() >= 2 ** 40:
            raise ValueError(f"{name} has stride {stride} (elements), "
                             f"which the tensor-core kernel's TMA loads "
                             f"cannot take: strides must be positive "
                             f"multiples of 16 bytes below 2^40")
        out.append(stride)
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, q_block: int = 128,
                          kv_block: int = 128) -> torch.Tensor:
    """Plain PyTorch version: the Pallas kernel's blocked online softmax
    over ``(q_block, kv_block)`` tiles, in fp32.  A ragged last tile is
    simply shorter."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    qb, kb = min(q_block, S), min(kv_block, T)
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, S, D)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Hkv, G, S, D), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, S, qb):
        q1 = min(q0 + qb, S)
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((B, Hkv, G, q1 - q0, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, q1 - q0, D), device=q.device)
        for k0 in range(0, T, kb):
            if causal and k0 > q1 - 1:
                break                   # wholly above the diagonal
            k1 = min(k0 + kb, T)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qf[:, :, :, q0:q1],
                             kf[:, :, k0:k1]) * scale
            if causal:
                k_pos = torch.arange(k0, k1, device=q.device)[None, :]
                s = torch.where(q_pos >= k_pos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            m = m_new
            acc = acc * corr + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                            vf[:, :, k0:k1])
        out[:, :, :, q0:q1] = acc / l.clamp(min=1e-37)
    return out.reshape(B, H, S, D).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    common.check_attention_operands("attention", q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, H, S, D) and k, v (B, Hkv, T, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: same B and D, H a multiple "
                         f"of Hkv")
    common.check_head_dim(D)
    if min(B, H, S, k.shape[2]) < 1:
        raise ValueError("the kernel takes non-empty B, H, S and T")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along D")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Launch the attention kernel on the card; the output has q's
    layout (strides) and dtype."""
    _check(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    kind = variant(q.dtype, D)
    out = torch.empty_like(q)
    lib = common.bind(_SOURCE, _ENTRIES, "fa_error_string")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kind == "wgmma":
        entry = "fa_forward_wgmma"
        strides = [x for name, t in (("q", q), ("k", k), ("v", v))
                   for x in tma_strides(name, t)] + list(out.stride()[:3])
        err = lib.fa_forward_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Hkv, S, T, D, (ctypes.c_longlong * 12)(*strides), int(causal),
            1.0 / math.sqrt(D), q.device.index, stream)
    else:
        entry = "fa_forward"
        strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
        err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), common.DTYPE_CODES[q.dtype], B,
                             H, Hkv, S, T, D, *strides, int(causal),
                             1.0 / math.sqrt(D), q.device.index, stream)
    common.raise_on_error(lib, "fa_error_string", entry, err)
    VARIANT_LAUNCHES[kind] += 1
    return out


def wgmma_smem_bytes(D: int) -> int:
    """Dynamic shared memory per CTA of the tensor-core kernel."""
    return common.bind(_SOURCE, _ENTRIES,
                       "fa_error_string").fa_wgmma_smem_bytes(D)
