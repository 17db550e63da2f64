"""The shapes and tolerances at which each CUDA kernel is held against
its plain PyTorch version on the card: one definition for the card
tests (``tests/test_torch_cuda.py``) and the smoke run
(``chip_smoke.py``).

Tolerances, as ``(atol, rtol)`` for ``torch.testing.assert_close``:

- flash attention, fp32: 2e-5, the reference's own kernel test — the
  kernel and the plain version do the same fp32 arithmetic in another
  order;
- flash attention, bf16: both widen the inputs to fp32, compute alike
  and round the output to bf16 once, so an element differs by at most
  one bf16 step (2^-7 of its size) plus the fp32 difference; held at
  two steps, ``rtol = 2^-6``, with ``atol = 1e-4``.  A dropped,
  repeated or mis-rescaled key tile moves a late row by some per cent
  and fails it (the reference's looser 0.05 would not).  The
  tensor-core kernel takes p in two bf16 terms (hi + lo) to stay within
  it: p rounded once to bf16 would not (``tests/test_torch_kernels.py``);
- flash decode partials: 1e-4 on o and l, 1e-5 on m (all fp32);
- the stacked bag: bitwise, fp32 and bf16 alike (the kernel and its
  plain version add the same fp32 terms in the same order and round the
  sum once);
- the flat bags on ``NMP_GRID``: bitwise, fp32 and bf16 alike (a bf16
  row widens to fp32 exactly, and the fp32 output adds the same terms in
  the same order).
"""
from __future__ import annotations

import numpy as np
import torch

#: embedding bags: T tables, R rows each, D wide, B bags of P slots
BAG_GRID = [(1, 64, 8, 4, 4), (4, 100, 16, 8, 10), (3, 257, 32, 5, 7),
            (2, 128, 128, 16, 20),
            (3, 96, 13, 6, 5),        # D not a multiple of the vector width
            (2, 50, 8, 5, 1)]         # single-slot bags

#: the NMP kernel's edges, run by both flat kernels: T tables, R rows
#: each, D wide, B bags of P slots; each bag's first binomial(P, fill)
#: slots drawn from the table, a share ``holes`` of them padding, the rest
#: of the bag padding, and bag (0, 0) all padding (``nmp_idx``)
NMP_GRID = [
    (4, 64, 128, 64, 80, 0.7, 0.0),   # RM1's widths at small R, tails
    (3, 50, 128, 6, 41, 0.8, 0.25),   # P > 32, P % K != 0, holes
    (2, 40, 128, 1, 20, 0.8, 0.25),   # B = 1
    (3, 40, 64, 13, 12, 0.8, 0.25),   # B = 13: 39 bags, a block of 7 warps
    (1, 100, 128, 64, 24, 0.7, 0.25),  # T = 1, B = 64
    (2, 30, 1024, 6, 9, 0.8, 0.25),   # D = 1024: the fewest rows in flight
    (3, 40, 512, 5, 17, 0.8, 0.25),   # D = 512: 4 float4 columns a lane
    (3, 40, 256, 7, 19, 0.8, 0.25),   # D = 256: K = 4 fp32, 8 bf16
    (3, 40, 4, 9, 33, 0.8, 0.25),     # D = 4: one lane loads
    (3, 40, 13, 6, 10, 0.8, 0.25),    # D = 13: the scalar path
    (2, 40, 128, 5, 64, 1.0, 0.5),    # half the slots holes, none a tail
]
#: the NMP kernel's warps (bags) a block
NMP_WARPS_PER_BLOCK = 8

#: the stacked bag: T, R, D, B, P and how far past each table's end the
#: rows reach (such a row reads the table's last row)
STACKED_GRID = [shape + (0,) for shape in BAG_GRID] + [
    (4, 10, 12, 3, 6, 4),             # rows past the end
    (3, 96, 13, 6, 5, 8),             # rows past the end, D % 4 != 0
    (5, 33, 20, 4, 40, 3)]            # P > 32: two index loads per bag

ATTN_GRID = [  # B, H, Hkv, S, T, D
    (2, 4, 4, 128, 128, 64),          # G = 1
    (2, 9, 3, 200, 200, 64),          # G = 3, ragged S = T
    (1, 6, 2, 77, 131, 128),          # G = 3, D = 128, ragged, S < T
    (1, 2, 2, 150, 40, 128),          # S > T
    (1, 2, 2, 150, 40, 32),           # D = 32
    (8, 9, 3, 1024, 1024, 64),        # smollm-135m's full-width prefill
    # the edges of the tensor-core kernel's 128-row q and 64-key tiles
    (1, 4, 2, 1, 300, 64),            # S = 1, T = 300
    (1, 3, 1, 100, 300, 64),          # T % 64 != 0, S < T
    (1, 3, 1, 300, 200, 64),          # T % 64 != 0, S > T
    (2, 4, 2, 190, 256, 128),         # D = 128, ragged S
    (1, 6, 2, 129, 129, 64),          # G = 3, a second q tile of one row
    # the LM zoo's prefill shapes
    (1, 20, 20, 1500, 1500, 64),      # whisper's encoder (non-causal)
    (2, 20, 20, 64, 1500, 64),        # whisper's cross-attention, S != T
    (1, 48, 8, 300, 300, 128),        # qwen2.5-14b: G = 6, padded heads
    (1, 32, 8, 1088, 1088, 128),      # llava: 576 patches + 512 tokens
    # head dim 112 (zamba2-7b's shared block): wgmma in bf16, padded to 128
    (4, 32, 32, 512, 512, 112),       # zamba2-7b's full-width prefill
    (2, 3, 3, 77, 77, 112),           # G = 1, ragged S = T
    (1, 4, 4, 130, 200, 112),         # G = 1, ragged S < T
]
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -6)}

DECODE_GRID = [  # B, H, Hkv, T, D, pos, kv_offset
    (2, 4, 4, 256, 64, 10, 0),        # pos early, G = 1
    (2, 9, 3, 256, 64, 130, 0),       # pos in the middle, G = 3
    (2, 9, 3, 256, 64, 255, 0),       # pos at the last row
    (3, 6, 2, 200, 128, 150, 0),      # D = 128, ragged T
    (2, 9, 3, 256, 64, 300, 256),     # kv_offset > 0, pos cuts the slice
    (2, 9, 3, 256, 64, 100, 256),     # a slice wholly after pos
    # the edges of the split-KV kernel's cut (flash_decode.num_splits)
    (8, 9, 3, 2048, 64, 1087, 0),     # smollm-135m's last decode launch
    (1, 2, 1, 4096, 128, 4095, 0),    # one long group: the most splits
    (2, 9, 3, 256, 64, 0, 0),         # pos 0: one live row
    (2, 9, 3, 256, 64, 1000, 0),      # pos past T: every row
    (2, 6, 2, 300, 32, 299, 0),       # T a multiple of no chunk, D = 32
    (3, 8, 2, 200, 16, 173, 0),       # D = 16, G = 4
    (96, 9, 3, 128, 64, 100, 0),      # B * Hkv = 288: one split
    (2, 32, 4, 512, 128, 300, 0),     # G = 8: two passes of 4 heads
    (2, 10, 2, 96, 32, 80, 0),        # G = 5: a last pass of 1 head
    (1, 16, 1, 128, 128, 127, 0),     # G * D = 2048, the widest group
    (2, 9, 3, 512, 64, 700, 512),     # a second slice that pos cuts
    # the LM zoo's decode shapes
    (2, 20, 20, 1500, 64, 1500, 0),   # whisper's cross cache, pos past T
    (2, 48, 8, 600, 128, 599, 0),     # qwen2.5-14b: G = 6, padded heads
    # head dim 112 (zamba2-7b's shared block): 14 of 16 lanes a row carry
    # data in bf16, 28 of 32 in fp32
    (4, 32, 32, 1024, 112, 527, 0),   # zamba2-7b's last decode launch
    (2, 4, 2, 200, 112, 0, 0),        # G = 2, pos 0
    (2, 4, 2, 300, 112, 150, 0),      # G = 2, pos mid-cache
    (2, 3, 3, 96, 112, 500, 0),       # G = 1, pos past T
]
DECODE_TOL = (1e-4, 1e-4, 1e-5)       # o, l, m


def randn(rng: np.random.RandomState, shape, device,
          dtype: torch.dtype) -> torch.Tensor:
    """Standard normal values drawn with numpy, on ``device`` in
    ``dtype``."""
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        device, dtype)


def bag_idx(rng: np.random.RandomState, R: int, B: int, T: int, P: int,
            past_end: int = 0) -> np.ndarray:
    """Indices (B, T, P) int32 into a stack of R-row tables: rows drawn
    from [0, R + past_end), padding tails of mixed length made of -1 and
    -7 (any negative slot is padding), and bag (0, 0) all padding."""
    idx = rng.randint(0, R + past_end, (B, T, P))
    lens = rng.randint(0, P + 1, (B, T))
    lens[0, 0] = 0
    pad = np.where(rng.rand(B, T, P) < 0.5, -1, -7)
    mask = np.arange(P)[None, None, :] < lens[..., None]
    return np.where(mask, idx, pad).astype(np.int32)


def nmp_idx(rng: np.random.RandomState, R: int, B: int, T: int, P: int,
            fill: float, holes: float) -> np.ndarray:
    """Indices (B, T, P) int32 for ``NMP_GRID``: each bag's first
    binomial(P, fill) slots drawn from [0, R), a share ``holes`` of them
    turned into padding between valid slots, the tail padding; padding
    is -1 or -7, and bag (0, 0) is all padding."""
    idx = rng.randint(0, R, (B, T, P))
    lens = rng.binomial(P, fill, (B, T))
    lens[0, 0] = 0
    keep = ((np.arange(P)[None, None, :] < lens[..., None])
            & (rng.rand(B, T, P) >= holes))
    pad = np.where(rng.rand(B, T, P) < 0.5, -1, -7)
    return np.where(keep, idx, pad).astype(np.int32)


def nmp_schedule(D: int, itemsize: int, vec: bool = True):
    """The NMP kernel's choice from the shapes alone, as
    ``csrc/embedding_bag.cu`` makes it (``nmp_chunks``,
    ``nmp_rows_in_flight``; the library's ``eb_nmp_schedule`` reports
    it): (float4 columns a lane, 0 on the scalar path; rows in flight a
    warp), the rows' loads taking about 32 registers a lane (4 a column
    of fp32, 2 of bf16), at least 2 rows and at most 8."""
    if not vec:
        return 0, 1
    chunks = next(c for c in (1, 2, 4, 8) if D <= 128 * c)
    regs = chunks * itemsize
    return chunks, max(2, min(8, 32 // regs))
