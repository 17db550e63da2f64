"""Flash-attention forward: a CUDA kernel for Hopper and its plain
PyTorch version.

``flash_attention`` (CUDA ``fa_forward``, ``csrc/flash_attention.cu``)
    Replaces ``repro/kernels/flash_attention.py:flash_attention``, the
    Pallas kernel of the prefill attention.  q ``(B, H, S, D)``, k and v
    ``(B, Hkv, T, D)`` -> o ``(B, H, S, D)`` in q's dtype: online softmax
    in fp32 with scale ``1/sqrt(D)``, causal mask ``q_pos >= k_pos`` with
    positions counted from 0 on both axes, masked logits ``-1e30``, key
    tiles wholly above the diagonal skipped, ``o = acc / max(l, 1e-37)``,
    and GQA through ``h // G``.

Bound on the card: operations.  Causal prefill does
``4 * B * H * D * S (S + 1) / 2`` flops on ``2 * (B H S D + B Hkv T D)``
elements; at smollm-135m's prefill (B=8, S=1024, H=9, D=64) that is 9.7
GFLOP, 0.0098 ms at the bf16 tensor-core rate.  The kernel is the simple
first version: one CTA per (64-row q tile, head, batch), K/V tiles staged
in shared memory, scalar fp32 FMAs; the source says more.

The kernel works on its own 64 x 64 tiles, so the ``q_block`` and
``kv_block`` arguments shape only the plain version's blocking (the two
differ by fp32 rounding order only).  Each operand may be a strided view
whose last axis is contiguous: ``layers`` hands in ``(B, S, H, D)``
tensors permuted to ``(B, H, S, D)`` and gets its output in the same
layout, with no copy.

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
            + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}


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
    lib = common.bind(_SOURCE, _ENTRIES, "fa_error_string")
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), common.DTYPE_CODES[q.dtype], B, H,
                         Hkv, S, T, D, *strides, int(causal),
                         1.0 / math.sqrt(D), q.device.index, stream)
    common.raise_on_error(lib, "fa_error_string", "fa_forward", err)
    return out
