"""The readings the check's limits are set from (not part of a run).

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 12 [--out readings_<cell>.jsonl]

For each seed, one run of the cell with a short window at the cell's own
sizes, in this one process: the program's numbers against the plain
reference, and the control's (the reference in TF32 in the program's
place), judged against the cell's limits as a run judges the program.
Prints one JSON line per seed and, at the end, per number the largest
program reading and the smallest control reading.
"""
import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    from portbench.harness.session import run_cell
    from portbench.harness.spec import load_cell
    cell = load_cell(args.workload, root)
    rows = []
    for seed in (int(x) for x in args.seeds.split(",")):
        r = run_cell(cell, seed, args.seconds, False, device="cuda", root=root,
                     readings=True)
        row = {"seed": seed, "program": {k: v["value"]
                                         for k, v in r["check"].items()},
               "control": {k: v["value"]
                           for k, v in r["control"]["check"].items()},
               "control_correct": r["control"]["correct"],
               "frames": r["attempted"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    names = sorted({k for r in rows for k in r["program"]})
    for k in names:
        p = [r["program"][k] for r in rows if r["program"].get(k) is not None]
        c = [r["control"][k] for r in rows
             if r["control"].get(k) is not None]
        print(f"{k}: program max {max(p) if p else None} over {len(p)}, "
              f"control min {min(c) if c else None} over {len(c)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
