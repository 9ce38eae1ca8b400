"""What the port's spans cost with no profiler collecting.

``lshrs_tpu_torch.utils.trace.span`` checks whether a profiler collects and
returns a shared no-op when none does. This script measures, on the host
that runs it, each over many calls: the check alone (``guard_ns``), a span
entered and left with no profiler (``span_off_ns``) and, for comparison, a
bare ``record_function`` with no profiler (``record_function_off_ns``).
Where CUDA is there it also says whether ``emit_nvtx()`` turns the spans on
(``nvtx_on``). What the spans cost while a profiler collects is read from
the benchmark's traced runs against its untraced ones.

Usage, from the repository root:

    python3 benchmarks/torch_span_cost.py

Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402


def _per_call_ns(fn, calls: int) -> float:
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t) / calls * 1e9


def main(calls: int = 1_000_000) -> dict:
    from torch.profiler import record_function

    from lshrs_tpu_torch.utils import trace

    def off_span():
        with trace.span("lshrs.x"):
            pass

    def bare():
        with record_function("lshrs.x"):
            pass

    out = {"torch": torch.__version__,
           "card": torch.cuda.get_device_name() if torch.cuda.is_available() else None,
           "guard_ns": _per_call_ns(torch.autograd._profiler_enabled, calls),
           "span_off_ns": _per_call_ns(off_span, calls),
           "record_function_off_ns": _per_call_ns(bare, max(1, calls // 10))}
    if torch.cuda.is_available():
        with torch.autograd.profiler.emit_nvtx():
            out["nvtx_on"] = trace.span("lshrs.x") is not trace._OFF
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
