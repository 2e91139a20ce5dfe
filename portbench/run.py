"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Builds the kernels into the checkout's
`build/`, writes the cell's sequence for the seed into
`.portbench_cache/sequences/<cell>/<seed>/` once, sets up the engine,
warms up on frames 0 and 1, measures `process_frame` for the window and
checks the sampled frames against the plain reference. The last line of
standard output is the result's JSON object; with --trace 1 its metrics
are the per-layer ones. Exits non-zero, with no result, without enough
CUDA cards, or when a run cannot give one.
"""
import time

T_PROCESS0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    # everything the run caches stays inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(root, ".portbench_cache", "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(root, ".portbench_cache", "triton"))
    os.environ["USE_FLAX"] = "0"
    from portbench.harness.spec import load_cell
    cell = load_cell(args.workload, root)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"CUDA available: {torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(root, "vtgaussian_slam_tpu_torch")):
        print("portbench: the port vtgaussian_slam_tpu_torch is not in this "
              "checkout", file=sys.stderr)
        return 2
    from portbench.harness.session import RunFailed, run_cell
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device="cuda", t_process0=T_PROCESS0, root=root)
    except RunFailed as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
