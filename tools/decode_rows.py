#!/usr/bin/env python3
"""Dump, or compare bitwise, the flash-decode kernel's partials on the
rows of ``cases.DECODE_GRID`` at the head dims 16, 32, 64 and 128, in
fp32 and bf16, on a CUDA card.

    python3 tools/decode_rows.py --src OTHER/src --out a.npz   # another tree
    python3 tools/decode_rows.py --out b.npz                   # this tree
    python3 tools/decode_rows.py --compare a.npz b.npz

``--src`` names the ``src`` directory whose ``repro_torch`` package (and
its ``csrc``, built into that tree's ``build/``) runs the rows, so two
versions of the kernel can be held bitwise against each other on the
same inputs: the rows come from the package that runs, the inputs from
``cases.randn`` seeded per row.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

KEPT_HEAD_DIMS = (16, 32, 64, 128)


def dump(src: Path, out: Path) -> int:
    sys.path.insert(0, str(src))
    import torch
    from repro_torch.kernels import cases, ops

    if not torch.cuda.is_available():
        print("decode_rows: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    arrays = {}
    for (B, H, Hkv, T, D, pos, off) in cases.DECODE_GRID:
        if D not in KEPT_HEAD_DIMS:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.RandomState(T + D + pos)
            q = cases.randn(rng, (B, H, D), dev, dtype)
            kc = cases.randn(rng, (B, T, Hkv, D), dev, dtype)
            vc = cases.randn(rng, (B, T, Hkv, D), dev, dtype)
            pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
            got = ops.flash_decode_partial(q, kc, vc, pos_t, kv_offset=off)
            key = f"{B}_{H}_{Hkv}_{T}_{D}_{pos}_{off}_{str(dtype)[6:]}"
            for name, t in zip("olm", got):
                arrays[f"{key}_{name}"] = t.cpu().numpy()
    np.savez(out, **arrays)
    print(f"decode_rows: {len(arrays) // 3} launches from {src} -> {out}")
    return 0


def compare(a: Path, b: Path) -> int:
    x, y = np.load(a), np.load(b)
    assert sorted(x.files) == sorted(y.files), (x.files, y.files)
    differ = [k for k in x.files
              if x[k].tobytes() != y[k].tobytes()]
    print(f"decode_rows: {len(x.files) // 3} launches, "
          f"{len(x.files)} arrays; bitwise different: {differ or 'none'}")
    return 1 if differ else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", type=Path,
                   default=Path(__file__).resolve().parents[1] / "src")
    p.add_argument("--out", type=Path)
    p.add_argument("--compare", type=Path, nargs=2)
    args = p.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    return dump(args.src.resolve(), args.out)


if __name__ == "__main__":
    sys.exit(main())
