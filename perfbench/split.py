"""The program's spans in a traced window of one cell, a request at a time.

Makes the cell's data, index and client as the harness does, then serves
its requests for ``--seconds`` under the profiler, inside the harness's
window span, and prints what `perfbench.spans` reads there: for each
``lshrs.*`` span, a request's host ms, device ms, copy ms, device
operations and card-idle ms, both its own (``inner``) and all that lies
inside it (``total``). ``--proposed`` also finds the cells of
``perfbench/tests/proposed.json``. The answers are not checked here:
``perfbench/run.py`` makes the benchmark's runs.

    python3 perfbench/split.py --workload <cell> --seed <n> --seconds <s> [--proposed]

One JSON line on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])


def split(cell, *, seed: int, seconds: float, device="cuda") -> dict:
    """Serve ``cell`` for ``seconds`` traced; the split a request by span."""
    import torch
    from torch.profiler import record_function

    from perfbench import devtrace, harness, spans
    from perfbench.data import make_data

    client = harness.load_module(cell.root / "perfbench" / "clients" / f"{cell.mix['client']}.py")
    train, test = make_data(cell.config, seed, device)
    state = client.setup(cell, train, test, seed, device)
    with devtrace.profiler():  # the tracer starts outside the window
        torch.ones(1, device=device).add_(1)
    requests = 0
    with devtrace.profiler() as prof:
        with record_function(devtrace.WINDOW):
            start = time.perf_counter()
            while time.perf_counter() - start < seconds or not requests:
                client.request(state, requests)
                requests += 1
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - start
    client.close(state)
    t = spans.read(prof)
    rows = {} if t is None else {
        kind: {name: {"host_ms": r.host_s * 1e3 / requests, "device_ms": r.device_s * 1e3 / requests,
                      "copy_ms": r.copy_s * 1e3 / requests, "ops": r.ops / requests,
                      "idle_ms": r.idle_s * 1e3 / requests}
               for name, r in sorted(getattr(t, kind).items())}
        for kind in ("inner", "total")}
    return {"workload": cell.name, "seed": seed, "requests": requests,
            "window_s": window_s, **rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--proposed", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from perfbench import harness

    spec = harness.load_spec()
    if args.proposed:
        from perfbench.tests.proposed import with_proposed

        spec = with_proposed(spec)
    cell = harness.resolve(spec, args.workload)
    print(json.dumps(split(cell, seed=args.seed, seconds=args.seconds, device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
