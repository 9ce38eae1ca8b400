"""Closed loop of index builds, as ann-benchmarks' ``fit``: each cycle
indexes every train vector (float32 on the host) into a new, empty
``LSHRS`` with one ``index`` call, takes a ``serving_fn(top_k)`` and sends
one request of ``readback`` stored vectors, drawn from the seed, whose
ids it waits for on the host; then closes the index. A cycle makes the
train set servable.

Mix parameters: ``readback``, ``top_k``, ``keep`` (cycles whose read-back
answers are kept for the check, a seeded sample).
"""

from __future__ import annotations

import numpy as np
from torch.profiler import record_function

from perfbench.harness import Reservoir


def _cycle(state: dict, rows: np.ndarray) -> np.ndarray:
    from lshrs_tpu_torch import LSHRS

    lsh = LSHRS(**state["index"], device=state["device"])
    try:
        with record_function("index"):
            lsh.index(state["ids"], state["train"])
        with record_function("serving_fn"):
            serve = lsh.serving_fn(top_k=state["top_k"])
        with record_function("readback"):
            return serve(state["train"][rows])
    finally:
        lsh.close()


def setup(cell, train, test, seed, device) -> dict:
    state = {"index": cell.config["index"], "device": device, "train": train,
             "ids": np.arange(len(train)), "top_k": cell.mix["top_k"],
             "readback": cell.mix["readback"], "rng": np.random.default_rng(seed % (1 << 64)),
             "kept": Reservoir(cell.mix["keep"], seed)}
    _cycle(state, np.arange(state["readback"]))  # warm every shape of a cycle
    return state


def request(state: dict, i: int) -> dict:
    rows = state["rng"].integers(0, len(state["train"]), state["readback"])
    with record_function("cycle"):
        ids = _cycle(state, rows)
    state["kept"].offer((rows, ids))
    return {"vectors": len(state["train"])}


def answers(state: dict):
    """``("train", rows, ids)``: the kept cycles' read-back rows and answers
    (None when no cycle answered)."""
    kept = state["kept"].items
    if not kept:
        return None
    return "train", np.concatenate([r for r, _ in kept]), np.concatenate([i for _, i in kept])


def close(state: dict) -> None:
    state.clear()
