"""Plain PyTorch oracles for every kernel (the counterparts of
``repro/kernels/ref.py``): one-shot computations, independent of the
kernels' blocking, that the tests hold the kernels against."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.embedding_bag import embedding_bag_stacked_sum


def _past_end(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, T, P, 1): True where a slot names a row past its table's end,
    which ``jnp.take`` (the reference's gather, in its default fill mode)
    reads as NaN."""
    return (idx >= tables.shape[1]).unsqueeze(-1)


def embedding_bag_ref(tables: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """tables (T, R, D); idx (B, T, P) int32, -1 padded -> (B, T, D) in
    the tables' dtype.  Sums each bag's slots in one reduction, like
    ``repro.models.dlrm.embedding_bag_ref``; that sum may reassociate, so
    it is close to, not bitwise equal to, the kernels.  A slot past its
    table's end makes its bag NaN, as the reference's gather does; the
    gather itself reads a clamped row, so a CUDA tensor never asserts."""
    T, R, _ = tables.shape
    valid = (idx >= 0).unsqueeze(-1)
    safe = idx.clamp(0, R - 1).to(torch.int64)
    tix = torch.arange(T, device=tables.device)[None, :, None]
    rows = torch.where(valid, tables[tix, safe], 0.0)         # (B,T,P,D)
    return rows.masked_fill(_past_end(tables, idx), float("nan")).sum(dim=2)


def embedding_bag_seq_ref(tables: torch.Tensor, idx: torch.Tensor
                          ) -> torch.Tensor:
    """Order-exact oracle: slots added in ascending order into fp32, the
    order the kernels use, so fp32 results match them bitwise.  A bag
    with a slot past its table's end is NaN, as in the reference's
    ``ref.embedding_bag_seq_ref``."""
    past = _past_end(tables, idx).any(dim=2)                  # (B,T,1)
    return embedding_bag_stacked_sum(tables, idx).masked_fill(
        past, float("nan"))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, Hkv, T, D) -> (B, H, S, D): one full
    softmax in fp32 (masked logits -inf), cast to q's dtype."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, S, D)
    s = torch.einsum("bhgsd,bhtd->bhgst", qg.float(), k.float()) * D ** -0.5
    if causal:
        qp = torch.arange(S, device=q.device)[:, None]
        kp = torch.arange(T, device=q.device)[None, :]
        s = torch.where(qp >= kp, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, kv_offset: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial decode attention (unnormalised o, l, m) in one pass, as
    the reference's ``layers.decode_attention_local`` computes it: rows
    after ``pos`` masked to -inf (so a slice wholly after ``pos`` gives
    m = -inf, l = 0, o = 0), and p rounded to the cache dtype before the
    PV product, whose result keeps that dtype."""
    B, H, D = q.shape
    Hkv = k_cache.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bthd->bhgt", qg.float(),
                     k_cache.float()) * D ** -0.5
    t = kv_offset + torch.arange(k_cache.shape[1], device=q.device)
    s = torch.where(t <= torch.as_tensor(pos, device=q.device), s,
                    float("-inf"))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    # rows may be fully masked on a slice past pos -> p=0, l=0 (safe)
    p = torch.where(torch.isfinite(m)[..., None], p, 0.0)
    l = p.sum(-1)
    o = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float()).to(v_cache.dtype)
    return o.reshape(B, H, D), l.reshape(B, H), m.reshape(B, H)


def decode_attention_full_ref(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, pos) -> torch.Tensor:
    """Normalised single-slice decode attention output, in the cache
    dtype."""
    o, l, _ = flash_decode_ref(q, k_cache, v_cache, pos)
    return (o / l.clamp(min=1e-37)[..., None]).to(o.dtype)
