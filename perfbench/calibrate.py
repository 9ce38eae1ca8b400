"""Readings for a cell's limits (``checks/<cell>.json``), on the card.

For each seed, one short run of the cell exactly as the benchmark makes it
(the program's ``mismatch``: the lower reading is the largest over the
seeds), with the reference computed in TF32 put in the program's place
for the same queries (the control's ``control_mismatch``: the upper reading
is the smallest). All seeds run in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 --seconds 2

One JSON line per seed on standard output, then a summary line.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2_900_000_017)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    lows, highs = [], []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        cell = harness.resolve(spec, args.workload)
        r = harness.run(cell, seed=seed, seconds=args.seconds, trace=False, control=True)
        lows.append(r["checks"]["mismatch"]["value"])
        highs.append(r["control_mismatch"])
        print(json.dumps({"seed": seed, "correct": r["correct"], "attempted": r["attempted"],
                          "compared": r["compared"], "mismatch": lows[-1],
                          "control_mismatch": highs[-1],
                          "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                          "setup_s": r["metrics"]["setup_s"]["value"]}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "lower": max(lows),
                      "upper": min(highs), "card": torch.cuda.get_device_name()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
