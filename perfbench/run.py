"""Run one benchmark cell on the card and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero and prints no result when no CUDA card (or too few) is
there, when ``lshrs_tpu_torch`` cannot be imported, or when JAX or the
JAX package was loaded in this process.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Import from the checkout's root, not from this directory (its module
# names must not shadow others').
sys.path[0] = str(Path(__file__).resolve().parents[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import lshrs_tpu_torch  # noqa: F401  the system under test: no run without it
    from perfbench import harness

    cell = harness.resolve(harness.load_spec(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                         t0=T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"loaded in this process, and must not be: {', '.join(loaded)}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
