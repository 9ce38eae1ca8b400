"""The benchmark's spec plus the cells of ``proposed.json``: measured on
the card, holding no bound yet (``PERF.md``, Open questions). The tests run
them too, so that a later benchmark PR can list them by entries alone."""

import copy
import json
from pathlib import Path


def with_proposed(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    add = json.loads((Path(__file__).parent / "proposed.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        spec[key] += add[key]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.get("workloads", []).extend(add["also_report"].get(m["name"], []))
    return spec
