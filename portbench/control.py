#!/usr/bin/env python3
"""The readings that a cell's correctness limit is set from.

    python3 portbench/control.py --workload <cell> --seconds 3 \\
        --seeds <n> <n> ... [--out chiprun_out/control.json]

For each seed, in one process on the card: the cell's set-up, a short
window at the cell's own load, then the check of a run: the widest gap
between a served score and the fp32 reference's over the run's sample
(the program's reading), and the widest gap between the reference
computed with TF32 on and with it off over the same sample (the
control's reading).  The limit goes above the program's largest reading
and below the control's smallest.  One JSON line a seed, then the two.
"""
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import bench
    from portbench.families import dlrm
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    spec = bench.spec_of(args.workload)
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        s = dlrm.Session(spec["name"], spec["config"], spec["cell"],
                         spec["mix"], seed, "cuda")
        setup = time.perf_counter() - t
        t0, ends, requests, samples = bench.serve_window(s, args.seconds, False)
        t1 = ends[-1]
        s.free_program()
        chk = s.check(control=True)
        row = {"seed": seed, "program_gap": chk["gap"],
               "control_gap": chk["control_gap"],
               "compared_samples": chk["compared_samples"],
               "failed": chk["failed"], "reference_s": chk["reference_s"],
               "setup_s": setup, "samples_per_s": samples / (t1 - t0)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del s
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload,
               "device": torch.cuda.get_device_name(0),
               "program_max": max(r["program_gap"] for r in rows),
               "control_min": min(r["control_gap"] for r in rows),
               "rows": rows}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
