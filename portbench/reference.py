"""The plain reference of a DLRM's scores, in PyTorch.

It follows the model's equations and shares no code with the program:
each bag is the sum of its valid rows (slots with index -1 are padding);
the bottom MLP maps the dense features to D; the pooled tables are
projected to K features of D (``proj``: T x K); the pairwise
interaction takes the row-major upper triangle (diagonal excluded) of
the Gram matrix of the K + 1 features; the top MLP maps the bottom
output beside the interaction terms to one logit, and the score is its
sigmoid.  ReLU follows every MLP layer but the last.

``precision="fp32"`` computes every product in float32 (on the card with
TF32 off), as the configuration states.  ``precision="tf32"`` is the
control: the same computation with the products' operands in TF32 (on
the card the library's TF32 path; on the CPU each operand rounded to
TF32's 10-bit mantissa).  The bag sums stay float32 in both.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import numpy as np
import torch

PRECISIONS = ("fp32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    out = (bits + 0xFFF + lsb) & ~0x1FFF
    return out.view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str, device: torch.device) -> Iterator:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    if device.type != "cuda":
        yield
        return
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _mm(a: torch.Tensor, b: torch.Tensor, emulate: bool) -> torch.Tensor:
    if emulate:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def bag_sums(embed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """embed (T, R, D); idx (B, T, P) int, -1 padded -> (B, T, D)."""
    B, T, P = idx.shape
    idx = idx.to(torch.int64)
    valid = idx >= 0
    t = torch.arange(T, device=idx.device)[None, :, None]
    rows = embed[t, idx.clamp(min=0)]                      # (B, T, P, D)
    return (rows * valid[..., None]).sum(dim=2)


def _mlp(x: torch.Tensor, layers: Dict[str, torch.Tensor],
         emulate: bool) -> torch.Tensor:
    n = len(layers) // 2
    for i in range(n):
        x = _mm(x, layers[f"w{i}"], emulate) + layers[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def logits(params: Dict, dense: torch.Tensor, pooled: torch.Tensor,
           emulate_tf32: bool = False) -> torch.Tensor:
    """The tower on already pooled tables -> (B,) logits."""
    e = emulate_tf32
    bot = _mlp(dense, params["bottom"], e)                 # (B, D)
    # (B, T, D) x (T, K) -> (B, K, D)
    feats = _mm(pooled.transpose(1, 2), params["proj"], e).transpose(1, 2)
    z = torch.cat([bot[:, None, :], feats], dim=1)         # (B, F, D)
    gram = _mm(z, z.transpose(1, 2), e)                    # (B, F, F)
    F = z.shape[1]
    i, j = torch.triu_indices(F, F, offset=1, device=z.device)
    x = torch.cat([bot, gram[:, i, j]], dim=1)
    return _mlp(x, params["top"], e)[:, 0]


def scores(params: Dict, dense: np.ndarray, indices: np.ndarray,
           precision: str = "fp32", bag_block: int = 16,
           tower_block: int = 512) -> np.ndarray:
    """Scores of the samples (dense (N, F), indices (N, T, P)), on the
    device that ``params`` lie on, in blocks so that the gathered rows
    and the activations fit beside the parameters."""
    dev = params["embed"].device
    emulate = precision == "tf32" and dev.type != "cuda"
    out = []
    with torch.no_grad(), _matmul_precision(precision, dev):
        for s in range(0, dense.shape[0], tower_block):
            idx = torch.from_numpy(indices[s:s + tower_block]).to(dev)
            pooled = torch.cat([bag_sums(params["embed"], idx[b:b + bag_block])
                                for b in range(0, idx.shape[0], bag_block)])
            d = torch.from_numpy(dense[s:s + tower_block]).to(dev)
            out.append(torch.sigmoid(logits(params, d, pooled, emulate)).cpu())
    return torch.cat(out).numpy()
