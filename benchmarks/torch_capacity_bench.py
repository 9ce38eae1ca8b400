"""QPS against capacity for the port's Hamming serving engines on one GPU.

The port of ``benchmarks/capacity_bench.py`` to ``lshrs_tpu_torch``: the
same arguments, the same points and the same JSON row per (slots, engine).
It measures how the exact engine and the refinement cascade
(``hamming_cascade``) serve as capacity grows past 2**22 slots, where one
B2 launch's key no longer fits int32 (256 bits) and the store ranks its
bitplanes in 2**22-slot blocks (B2 once a block, merged exactly); the
chunked cores (plain torch, no kernel) serve what is forced onto them.

Method, as the reference's: gaussian vectors are drawn ON THE CARD in
512k-row chunks (``torch.randn`` from a ``torch.Generator`` seeded from
``(seed, chunk offset)``, so every engine at one capacity holds identical
content) and indexed by the fused hash + append
(``DeviceStore.add_vectors_batch`` with ``LSHHasher.device_projection``).
Serving uses ``snapshot_query_fn(10, mode="hamming", wire="words")``;
past 2**23 slots the exact engine serves in 1,024-query slices
(``dev_batch``) unless ``--dev-batch`` says otherwise. Self-match re-hashes
the first stored rows (the probe, 1,024 of them); planted recall@10 moves
them to ~0.8 cosine (``0.8 x^ + 0.6 n^``, noise from ``default_rng(999)``);
agreement@10 of each engine with the exact one is taken on those planted
queries. A trial submits every query batch (words hashed on the card,
held on the host) to three threads, each calling the closure; the main
thread reads the ids back. ``qps`` is the best trial, ``qps_median`` the
median.

Usage, from the repository root:

    python3 benchmarks/torch_capacity_bench.py [--slots 4194304 8388608 12500000]
        [--engines exact cascade128:8192 cascade64:8192] [--q 8192] [--batches 4]
        [--trials 3] [--group 64] [--dev-batch N] [--seed 7] [--smoke]
        [--device cuda|cpu]

Prints one JSON line per (slots, engine), then ``{"summary": [rows]}``.
Each row adds to the reference's fields the card (``nvidia-smi`` name and
power limit), the ranking route (``grouped``, ``blocked``, ``chunked`` or
``cascade``), the kernel launches of the timed trials, the point's
seconds and its peak device bytes. A failed check (a self-match below
1.0, ids out of range, a kernel launch missing on the grouped, blocked or
cascade route, or one made on the chunked route) prints
``{"check_failed": ...}`` on stderr and exits 1; nothing falls back.

``--smoke`` keeps every width and route and cuts sizes: 2**14 slots (the
grouped exact engine, kernel B2) and 2**23 (the smallest capacity whose
exact engine runs in blocks), exact, cascade128:8192 and cascade64:8192,
256-query batches, two of them, two trials and a 256-row probe.
``--device cpu`` runs the same paths on CPU tensors (the kernels' plain
versions: no launch is counted, no time means anything; 2**23 slots are
slow there, so pass ``--slots``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

NUM_BANDS, ROWS_PER_BAND = 16, 16  # num_perm = 256, 16 int32 words a slot
NUM_PERM = NUM_BANDS * ROWS_PER_BAND
DIM = 768
TOP_K = 10
CHUNK = 1 << 19  # 512k vectors a chunk: 1.5 GB of float32 on the card
PROBE = 1024  # stored rows re-hashed for self-match and planted recall
HASH_SEED = 42  # the reference's hasher seed
PLANTED_SEED = 999
QUERY_SEED = 123
# The exact engine from this capacity on is chunked; it serves in slices.
CHUNKED_DEV_BATCH_CAPACITY, CHUNKED_DEV_BATCH = 1 << 23, 1024
B1, B2, B3 = "group_max_keys", "hamming_group_max_keys", "hamming_packed_group_max_keys"
FULL = dict(slots=[1 << 22, 1 << 23, 12_500_000], engines=["exact", "cascade128:8192"],
            q=8192, batches=4, trials=3, probe=PROBE)
SMOKE = dict(slots=[1 << 14, 1 << 23], engines=["exact", "cascade128:8192", "cascade64:8192"],
             q=256, batches=2, trials=2, probe=256)


class CheckFailed(Exception):
    """A check of the run failed: the run exits 1 and names it."""

    def __init__(self, name: str, detail):
        super().__init__(f"{name}: {detail}")
        self.name, self.detail = name, detail


def check(ok: bool, name: str, detail) -> None:
    if not ok:
        raise CheckFailed(name, detail)


def counts_launches(device: torch.device) -> bool:
    """Whether the kernel wrappers count launches on ``device`` (on CPU
    tensors their plain versions run and nothing is counted)."""
    return device.type == "cuda"


def kernel_launches() -> dict:
    """The kernel wrappers' launch counters, B2's also by key packing
    ``(operand width, offset, shift)``."""
    from lshrs_tpu_torch.ops import group_max as gm

    return {
        B1: gm.group_max_keys.launches,
        B2: gm.hamming_group_max_keys.launches,
        B3: gm.hamming_packed_group_max_keys.launches,
        "by_packing": dict(gm.hamming_group_max_keys.launches_by_packing),
    }


def card(device: torch.device) -> dict:
    """``nvidia-smi``'s name and power limit of the card (``cpu`` on the CPU)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    name, limit = (f.strip() for f in out.stdout.strip().splitlines()[0].rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def to_host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def parse_engine(engine: str) -> tuple[int, int]:
    """``exact`` -> (0, 2048); ``cascadeN`` -> (N, 2048); ``cascadeN:R``
    -> (N, R): the prefix bits and the refine pool."""
    cascade, refine = 0, 2048
    if engine.startswith("cascade"):
        spec = engine[len("cascade"):]
        if ":" in spec:
            bits, pool = spec.split(":")
            cascade, refine = int(bits), int(pool)
        else:
            cascade = int(spec)
    elif engine != "exact":
        raise ValueError(f"engine must be exact, cascadeN or cascadeN:R; got {engine!r}")
    return cascade, refine


def chunk_seed(seed: int, off: int) -> int:
    """The generator seed of the chunk at row ``off``."""
    return int(np.random.SeedSequence([seed, off]).generate_state(1, np.uint64)[0])


def draw_chunk(seed: int, off: int, n: int, device: torch.device) -> torch.Tensor:
    """``n`` standard-normal float32 rows of ``DIM`` drawn on ``device``:
    the same rows for the same ``(seed, off)``, whatever came before."""
    gen = torch.Generator(device=device).manual_seed(chunk_seed(seed, off))
    return torch.randn((n, DIM), generator=gen, device=device)


def capacity_of(n_slots: int) -> int:
    """The reference's capacity: the next power of two, at least 2**17."""
    return max(1 << 17, int(2 ** np.ceil(np.log2(n_slots))))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_store(n_slots: int, hasher, *, cascade: int, refine: int, device: torch.device,
                group: int = 64, seed: int = 7, probe: int = PROBE):
    """A ``DeviceStore`` with ``n_slots`` rows drawn and hashed on the
    device; returns it, the build seconds and the first ``probe`` rows."""
    from lshrs_tpu_torch import DeviceStore

    store = DeviceStore(
        num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=DIM, enable_hamming=True,
        hamming_cascade=cascade, hamming_cascade_refine=refine, group_size=group,
        initial_capacity=capacity_of(n_slots), dedupe=False, device=device,
    )
    proj = hasher.device_projection()
    sync(device)
    t0 = time.perf_counter()
    probe_x = None
    for off in range(0, n_slots, CHUNK):
        n = min(CHUNK, n_slots - off)
        x = draw_chunk(seed, off, n, device)
        if off == 0:
            probe_x = x[:probe].clone()
        store.add_vectors_batch(np.arange(off, off + n), x, proj)
        del x
    sync(device)
    return store, time.perf_counter() - t0, probe_x


def probe_rng_noise(shape) -> np.ndarray:
    return np.random.default_rng(PLANTED_SEED).standard_normal(shape).astype(np.float32)


def planted_probe(px: np.ndarray) -> np.ndarray:
    """The probe rows moved to ~0.8 cosine: query i's planted neighbour is row i."""
    noise = probe_rng_noise(px.shape)
    q = 0.8 * px / np.linalg.norm(px, axis=1, keepdims=True) + 0.6 * (
        noise / np.linalg.norm(noise, axis=1, keepdims=True)
    )
    return q.astype(np.float32)


def route_of(store, cascade: int) -> str:
    """How the store ranks by Hamming: the cascade, the grouped exact
    engine (kernel B2 once), the same in blocks past one launch's key
    (B2 once a block) or the chunked cores (no kernel)."""
    from lshrs_tpu_torch.storage import device as store_mod

    if cascade:
        return "cascade"
    aligned = store._capacity % store.group == 0
    if aligned and store._capacity > store_mod.hamming_block_slots(NUM_PERM):
        return "blocked"
    grouped = aligned and store_mod.supports_hamming_grouped(NUM_PERM, store._capacity)
    return "grouped" if grouped else "chunked"


def check_launches(before: dict, route: str, cascade: int, calls: int, device) -> dict | None:
    """The timed trials' launches; on a device that counts them: B2 at
    least once a call on the grouped route and twice on the blocked one,
    B2 at the cascade's coarse packing (width and offset = the prefix
    bits) at least once a call on the cascade, and no kernel at all on the
    chunked route."""
    if not counts_launches(device):
        return None
    after = kernel_launches()
    got = {k: after[k] - before[k] for k in (B1, B2, B3)}
    got["cascade_coarse"] = sum(
        v - before["by_packing"].get(key, 0) for key, v in after["by_packing"].items()
        if key[0] == cascade and key[1] == cascade) if cascade else 0
    if route == "grouped":
        check(got[B2] >= calls, "grouped_exact_launches_b2", got)
    elif route == "blocked":
        check(got[B2] >= 2 * calls, "blocked_exact_launches_b2", got)
    elif route == "cascade":
        check(got["cascade_coarse"] >= calls, f"cascade{cascade}_launches_b2_coarse", got)
    else:
        check(got[B1] == got[B2] == got[B3] == 0, "chunked_exact_launches_no_kernel", got)
    return got


def check_ids(name: str, ids: np.ndarray, q: int, n: int) -> None:
    check(ids.shape == (q, TOP_K), f"{name}_shape", ids.shape)
    check(bool(((ids >= -1) & (ids < n)).all()), f"{name}_range", "ids out of [-1, n)")


def run_point(n_slots, engine, hasher, q, n_batches, trials, rng, *, device, group=64,
              dev_batch=None, seed=7, probe=PROBE, answers=None):
    cascade, refine = parse_engine(engine)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_point = time.perf_counter()
    store, build_s, probe_x = build_store(n_slots, hasher, cascade=cascade, refine=refine,
                                          device=device, group=group, seed=seed, probe=probe)

    # Past the int32 key ceiling the reference's exact engine is chunked
    # and splits its batch there (its chunk pools grow with Q).
    if dev_batch is None and not cascade and store._capacity >= CHUNKED_DEV_BATCH_CAPACITY:
        dev_batch = CHUNKED_DEV_BATCH
    serve = store.snapshot_query_fn(TOP_K, mode="hamming", wire="words", dev_batch=dev_batch)
    route = route_of(store, cascade)

    # self-match: re-hashed stored rows at Hamming 0 return their own id
    self_words = to_host(hasher.hash_batch_words(probe_x))
    got = to_host(serve(self_words))
    check_ids("self", got, len(self_words), n_slots)
    self_match = float((got[:, 0] == np.arange(len(got))).mean())
    check(self_match == 1.0, f"self_match_{engine}_{n_slots}", self_match)

    # planted neighbours: the probe rows at ~0.8 cosine
    probe_q = planted_probe(to_host(probe_x))
    probe_words = to_host(hasher.hash_batch_words(probe_q))
    probe_ids = to_host(serve(probe_words))
    check_ids("planted", probe_ids, len(probe_words), n_slots)
    planted = float((probe_ids == np.arange(len(probe_ids))[:, None]).any(axis=1).mean())

    raw = [to_host(hasher.hash_batch_words(rng.standard_normal((q, DIM)).astype(np.float32)))
           for _ in range(n_batches)]
    to_host(serve(raw[0]))  # warm the serving shape

    def timed_trial() -> tuple[float, list]:
        with ThreadPoolExecutor(max_workers=3) as pool:
            t0 = time.perf_counter()
            futs = [pool.submit(serve, b) for b in raw]
            out = [to_host(f.result()) for f in futs]
            dt = time.perf_counter() - t0
        return dt, out

    before = kernel_launches()
    ts, first = [], None
    for _ in range(trials):
        dt, out = timed_trial()
        for ids in out:
            check_ids("timed", ids, q, n_slots)
        if first is None:
            first = out
        check(all(np.array_equal(a, b) for a, b in zip(out, first)), "timed_repeatable",
              "a trial served other ids than the first")
        ts.append(dt)
    launches = check_launches(before, route, cascade, n_batches * trials, device)
    ts = sorted(ts)
    n_q = q * n_batches
    if answers is not None:
        answers[n_slots, engine] = dict(
            words=store.state_arrays()["sig"], capacity=store._capacity, cascade=cascade,
            refine=refine, group=group, self_words=self_words, self_ids=got,
            probe_words=probe_words, probe_ids=probe_ids, raw=raw, raw_ids=first)
    row = {
        "slots": n_slots,
        "engine": engine,
        "group": group,
        "dev_batch": dev_batch,
        "capacity": store._capacity,
        "qps": n_q / ts[0],
        "qps_median": n_q / ts[len(ts) // 2],
        "ms_per_batch": 1000 * ts[0] / n_batches,
        "self_match": self_match,
        "planted_recall_at_10": planted,
        "build_s": build_s,
        "plane_bytes": store.stats()["hamming_plane_bytes"],
        "route": route,
        "launches": launches,
        "seconds": time.perf_counter() - t_point,
        "peak_device_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "device": card(device),
    }
    del store, serve
    return row, probe_ids


def agreement_at_10(ref: np.ndarray, got: np.ndarray) -> float:
    """Mean share of the exact engine's top-10 that ``got`` serves."""
    return float(np.mean([len(set(ref[i]) & set(got[i])) / TOP_K for i in range(ref.shape[0])]))


def main(argv=None, *, answers: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, nargs="+", default=None)
    ap.add_argument("--engines", nargs="+", default=None)
    ap.add_argument("--q", type=int, default=None)
    ap.add_argument("--batches", type=int, default=None)
    ap.add_argument("--trials", type=int, default=None)
    ap.add_argument("--group", type=int, default=64)
    ap.add_argument("--dev-batch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=7, help="the data's seed (the reference's key)")
    ap.add_argument("--smoke", action="store_true", help="small sizes, every width and route kept")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    sizes = SMOKE if args.smoke else FULL
    for key in ("slots", "engines", "q", "batches", "trials"):
        if getattr(args, key) is None:
            setattr(args, key, sizes[key])
    for engine in args.engines:
        parse_engine(engine)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_capacity_bench: no CUDA device available (--device cpu runs the plain "
              "versions)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        from lshrs_tpu_torch.ops import _build

        _build.library()

    from lshrs_tpu_torch.hash.hasher import LSHHasher

    hasher = LSHHasher(NUM_BANDS, ROWS_PER_BAND, DIM, seed=HASH_SEED, device=device)
    rng = np.random.default_rng(QUERY_SEED)

    rows = []
    try:
        for n_slots in args.slots:
            ids_by_engine = {}
            for engine in args.engines:
                row, probe_ids = run_point(
                    n_slots, engine, hasher, args.q, args.batches, args.trials, rng,
                    device=device, group=args.group, dev_batch=args.dev_batch, seed=args.seed,
                    probe=min(sizes["probe"], n_slots), answers=answers,
                )
                ids_by_engine[engine] = probe_ids
                if "exact" in ids_by_engine and engine != "exact":
                    row["agreement_at_10_vs_exact"] = agreement_at_10(ids_by_engine["exact"], probe_ids)
                rows.append(row)
                print(json.dumps(row), flush=True)
    except CheckFailed as exc:
        print(json.dumps({"check_failed": exc.name, "detail": str(exc.detail)}), file=sys.stderr)
        return 1
    print(json.dumps({"summary": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
