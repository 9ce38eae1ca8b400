"""Closed loop of one client over the test set, as ann-benchmarks runs a
query phase: the index is built once from all train vectors
(``LSHRS.index``, its ``fit``), then each request is the next ``batch``
test queries, float32 on the host, through ``serving_fn(top_k)``, and
waits for the ids on the host. ``batch`` = the test set is its
``--batch`` mode; ``batch`` = 1 its sequential mode.

Mix parameters: ``batch``, ``top_k``, ``keep`` (answers kept for the
check, a seeded sample of the requests).
"""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from perfbench.harness import Reservoir

# Warm-up: at least two requests (the first builds the index's lazy tables)
# and at least a second of them, so the window starts in the steady state.
WARM_REQUESTS, WARM_SECONDS = 2, 1.0


def setup(cell, train, test, seed, device) -> dict:
    from lshrs_tpu_torch import LSHRS

    b = cell.mix["batch"]
    if len(test) % b:
        raise ValueError(f"batch {b} does not divide the {len(test)} test queries")
    lsh = LSHRS(**cell.config["index"], device=device)
    with record_function("index"):
        lsh.index(np.arange(len(train)), train)
    serve = lsh.serving_fn(top_k=cell.mix["top_k"])
    start, i = time.perf_counter(), 0
    while i < WARM_REQUESTS or time.perf_counter() - start < WARM_SECONDS:
        off = i * b % len(test)
        serve(test[off : off + b])
        i += 1
    return {"lsh": lsh, "serve": serve, "test": test, "batch": b,
            "kept": Reservoir(cell.mix["keep"], seed)}


def request(state: dict, i: int) -> dict:
    b = state["batch"]
    off = i * b % len(state["test"])
    with record_function("request"):
        ids = state["serve"](state["test"][off : off + b])
    state["kept"].offer((off, ids))
    return {"queries": b}


def answers(state: dict):
    """``("test", rows, ids)``: the kept requests' test rows and answers
    (None when no request answered)."""
    kept = state["kept"].items
    if not kept:
        return None
    rows = np.concatenate([np.arange(off, off + len(ids)) for off, ids in kept])
    return "test", rows, np.concatenate([ids for _, ids in kept])


def close(state: dict) -> None:
    state["lsh"].close()
    state.clear()
