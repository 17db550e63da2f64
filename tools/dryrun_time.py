#!/usr/bin/env python3
"""Host time, memory and FLOPs of dry-run cells, each cell in a fresh
process, for one or two source trees taken in turns (A, B, B, A), so
that two trees compare on the same host in one call.

    python3 tools/dryrun_time.py rwkv6-3b:train_4k:single \\
        rwkv6-3b:train_4k:multi --src src --src build/parent/src

A cell is ``arch:shape:single|multi`` (``launch.dryrun.run_cell`` on the
production mesh).  Prints one JSON line a run: the tree, the cell, the
seconds ``run_cell`` took, its ``temp_bytes``, ``total_per_device_bytes``
and ``cost.flops``.  The dry run allocates nothing on a card.
"""
import argparse
import json
import os
import subprocess
import sys

CELL = r"""
import json, sys, time
from repro_torch.launch import dryrun
arch, shape, mesh = sys.argv[1:4]
t0 = time.perf_counter()
rec = dryrun.run_cell(arch, shape, mesh == "multi")
m = rec["memory"]
print(json.dumps({"s": time.perf_counter() - t0, "temp": m["temp_bytes"],
                  "total": m["total_per_device_bytes"],
                  "flops": rec["cost"]["flops"]}))
"""


def run(src: str, cell: str, timeout: float) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", CELL, *cell.split(":")],
                         env=env, capture_output=True, text=True,
                         timeout=timeout, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("cells", nargs="+", help="arch:shape:single|multi")
    p.add_argument("--src", action="append",
                   help="a source tree (repeat for two; default: src)")
    p.add_argument("--timeout", type=float, default=600.0)
    args = p.parse_args(argv)
    srcs = args.src or ["src"]
    for cell in args.cells:
        for src in srcs + srcs[::-1]:
            rec = run(src, cell, args.timeout)
            print(json.dumps(dict(src=src, cell=cell, **rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
