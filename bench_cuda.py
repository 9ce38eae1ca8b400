"""Benchmark of the PyTorch + CUDA port (``lshrs_tpu_torch``) on one GPU.

The port of ``bench.py``: the same configurations, metric names and JSON
line, measured through the port's public entry points. Run from the
repository root on a machine with an NVIDIA GPU:

    python3 bench_cuda.py [--config all|topk_100k|build_100k|topk_1m|cascade_4m|packed_4m|topp_1m_int8]
                          [--seed 0] [--smoke] [--device cuda|cpu]

Widths are BASELINE config #1's throughout and are never cut: ``dim=768``,
16 bands x 16 rows (``num_perm=256``), top-10. The configurations:

- ``topk_100k`` (``bench.py:58-80,151-192``, the headline): 100,000
  gaussian vectors hashed on the host with the structured (FWHT) family
  into a ``DeviceStore``; a trial is 6 batches of 16,384 raw float32
  queries through a hasher thread (host hash to the 32-byte dense wire),
  one dispatch per batch (kernel B1) and a reader thread that copies the
  ids to the host, all three overlapping.
- ``build_100k`` (``bench.py:86-148``): the fused device build (vectors
  already on the card, gaussian hash + append in ``add_vectors_batch``)
  and the host-streamed build (structured host hash, dense wire,
  ``add_signature_batch``).
- ``topk_1m`` (``bench.py:196-323``): 2**20 clustered vectors through
  ``LSHRS(hash_mode="host", hash_family="structured")``, whose auto engine
  ranks by Hamming (kernel B2) past 2**19 slots; recall@10 and planted
  recall of 512 planted queries against the exact float32 cosine top-10;
  4 batches of 8,192 from three submitting threads.
- ``cascade_4m`` (``bench.py:325-416``): 2**22 gaussian vectors drawn on
  the card, served by the Hamming refinement cascade (a 128-bit prefix
  through B2, an 8,192-slot exact refine) on the words wire.
- ``packed_4m``: the same words in a packed store (kernel B3, no
  bitplanes) and a bitplane twin (B2), timed in alternating turns; packed
  ids must equal planes ids.
- ``topp_1m_int8``: ``topk_1m``'s vectors with an int8 payload, top-p
  cosine rerank through ``serving_fn(mode="topp")`` on 1,024-query
  batches; recall@10 against the exact float32 cosine top-10.

Each rate is the median of its trials, with the best beside it as
``<name>_best`` (``bench.py`` reported the best of N because its network
transport stalled; the card here is local). Every shape is warmed before
it is timed, a timed query trial ends when the ids are on the host and a
timed build on ``torch.cuda.synchronize()``; no profiler runs and TF32 is
off. Each configuration draws its data from ``--seed`` alone, so one run
alone gives the numbers it gives under ``all``.

Prints exactly one JSON line on stdout, in ``bench.py``'s shape:
``{"metric", "value", "unit", "vs_baseline", "extras"}``. ``extras``
holds every metric by name, ``units`` (metric -> unit), ``trials``
(metric -> trial count), ``seed``, ``setup_s`` (the kernel build and the
native host-hash library load, timed apart), ``seconds_<config>``,
``peak_device_bytes_<config>`` (``torch.cuda.max_memory_allocated``,
reset per configuration), ``run_s`` (the whole run) and ``device``
(``nvidia-smi``'s name and power limit). ``vs_baseline`` is
``bench.py``'s ratio, a QPS over 100,000 (BASELINE.json's north star,
not a result of this port). Progress goes to stderr, one JSON line per
configuration. A failed check (a self-match
below 1.0, a kernel that did not launch, engines that disagree) ends the
run with exit code 1 and names the check on stderr; nothing falls back to
the CPU or to a kernel's plain version.

``--smoke`` keeps every width, the top-10, the 128-bit cascade prefix and
each row's route and cuts only sizes (4,096-16,384 rows, query batches of
64-256, a 256-slot cascade pool, two trials); ``topk_1m`` then pins
``engine="hamming"``, since ``auto`` ranks by collision below 2**19 slots.
``--device cpu`` runs the same paths on CPU tensors (the kernels' plain
versions: no launch is counted there, and no time means anything).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

DIM, NUM_BANDS, ROWS = 768, 16, 16
NUM_PERM = NUM_BANDS * ROWS
TOP_K = 10
HASH_SEED = 42  # bench.py's hasher seed
BASELINE_QPS = 100_000.0  # bench.py's vs_baseline denominator
CASCADE_BITS = 128
CENTERS, NOISE = 4096, 0.35  # bench.py's clustered recipe
PLANTED_SEED = 999  # bench.py's planted-noise generator
B1, B2, B3 = "group_max_keys", "hamming_group_max_keys", "hamming_packed_group_max_keys"


@dataclass(frozen=True)
class Sizes:
    n_100k: int
    capacity_100k: int
    batch_100k: int
    batches_100k: int
    trials_100k: int
    build_trials: int
    stream_trials: int
    build_check: int
    n_1m: int
    step_1m: int
    batch: int  # the 1M and 4M query batch
    batches: int
    trials: int
    planted_1m: int
    n_4m: int
    draw_4m: int
    check_4m: int
    refine_4m: int
    topp_batch: int


FULL = Sizes(
    n_100k=100_000, capacity_100k=1 << 17, batch_100k=16384, batches_100k=6, trials_100k=5,
    build_trials=5, stream_trials=3, build_check=2048,
    n_1m=1 << 20, step_1m=1 << 16, batch=8192, batches=4, trials=3, planted_1m=512,
    n_4m=1 << 22, draw_4m=1 << 19, check_4m=1024, refine_4m=8192, topp_batch=1024,
)
SMOKE = Sizes(
    n_100k=8192, capacity_100k=1 << 13, batch_100k=256, batches_100k=2, trials_100k=2,
    build_trials=2, stream_trials=2, build_check=256,
    n_1m=1 << 14, step_1m=1 << 12, batch=128, batches=2, trials=2, planted_1m=64,
    n_4m=1 << 14, draw_4m=1 << 12, check_4m=64, refine_4m=256, topp_batch=128,
)
# Submitting threads of the 1M and 4M rows (bench.py:299-309).
THREADS = 3


class CheckFailed(Exception):
    """A check of the run failed: the run exits 1 and names it."""

    def __init__(self, name: str, detail):
        super().__init__(f"{name}: {detail}")
        self.name, self.detail = name, detail


def check(ok: bool, name: str, detail) -> None:
    if not ok:
        raise CheckFailed(name, detail)


def counts_launches(device: torch.device) -> bool:
    """Whether the kernel wrappers count launches on ``device``: on CUDA
    tensors they launch the kernels; on CPU tensors their plain versions
    run and nothing is counted."""
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


def to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# -- data and truth ---------------------------------------------------------


def gaussian_rows(seed: int, n: int) -> tuple[np.random.Generator, np.ndarray]:
    """``n`` standard-normal float32 rows from ``default_rng(seed)``, and
    the generator, which then draws the configuration's queries."""
    rng = np.random.default_rng(seed)
    return rng, rng.standard_normal((n, DIM), dtype=np.float32)


def clustered(seed: int, n: int, step: int):
    """bench.py's 1M data: ``n`` rows around 4,096 gaussian centres with
    0.35 gaussian noise, in ``step``-row chunks. Returns the generator
    (which then draws the queries), the centres and the chunks."""
    rng = np.random.default_rng(seed + 1)
    centers = rng.standard_normal((CENTERS, DIM), dtype=np.float32)
    chunks = []
    for _ in range(n // step):
        x = centers[rng.integers(0, CENTERS, step)]
        x += NOISE * rng.standard_normal((step, DIM), dtype=np.float32)
        chunks.append(x)
    return rng, centers, chunks


def planted_queries(x: np.ndarray) -> np.ndarray:
    """Stored rows moved to ~0.8 cosine, bench.py's probe
    (``bench.py:265-272``): ``0.8 x^ + 0.6 n^`` with the noise from
    ``default_rng(999)``; query i's planted neighbour is row i."""
    noise = np.random.default_rng(PLANTED_SEED).standard_normal(x.shape, dtype=np.float32)
    q = 0.8 * x / np.linalg.norm(x, axis=1, keepdims=True)
    q += 0.6 * noise / np.linalg.norm(noise, axis=1, keepdims=True)
    return q.astype(np.float32)


def draw_4m(seed: int, n: int, batch: int, device: torch.device):
    """The 4M rows, drawn on ``device`` in ``batch``-row blocks by a
    ``torch.Generator`` seeded with ``seed``: yields ``(offset, rows)``.
    bench.py draws them with ``jax.random``: the same distribution, not
    the same numbers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for off in range(0, n, batch):
        yield off, torch.randn((batch, DIM), generator=gen, device=device)


def exact_top10(queries: np.ndarray, chunks, device: torch.device) -> np.ndarray:
    """Ids of the exact float32 cosine top-10 of each query over the rows
    of ``chunks`` (numbered in order), by a plain product on ``device``
    (TF32 off), merged chunk by chunk. Independent of the code under
    test."""
    q = torch.from_numpy(queries).to(device)
    qn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    best = torch.empty((len(q), 0), device=device)
    ids = torch.empty((len(q), 0), dtype=torch.int64, device=device)
    off = 0
    for chunk in chunks:
        x = torch.from_numpy(chunk).to(device)
        s = qn @ (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).T
        v, i = torch.topk(s, min(TOP_K, s.shape[1]), dim=1)
        best, j = torch.topk(torch.cat([best, v], 1), min(TOP_K, best.shape[1] + v.shape[1]), dim=1)
        ids = torch.cat([ids, i + off], 1).gather(1, j)
        off += len(chunk)
    return to_host(ids)


def recall_at_10(ids: np.ndarray, truth: np.ndarray) -> float:
    """Mean share of each query's exact top-10 found in its served ids."""
    hits = [len(set(ids[r][ids[r] >= 0].tolist()) & set(truth[r].tolist())) for r in range(len(truth))]
    return float(np.mean(hits)) / TOP_K


def planted_recall(ids: np.ndarray) -> float:
    """Share of planted queries whose own row (query i -> row i) is served."""
    return float((ids == np.arange(len(ids))[:, None]).any(axis=1).mean())


def self_match(ids: np.ndarray, rows: np.ndarray) -> float:
    """Share of stored rows served as their own top-1."""
    return float((ids[:, 0] == rows).mean())


# -- timing ----------------------------------------------------------------


def pipelined_trial(hash_fn, serve, batches) -> tuple[float, list]:
    """bench.py's serving loop (``bench.py:151-192``): a hasher thread
    hashes raw batches, the caller dispatches one serving call per batch,
    a reader thread copies the ids to the host. Seconds from the first
    submission to the last ids on the host."""
    with ThreadPoolExecutor(1) as hash_pool, ThreadPoolExecutor(1) as read_pool:
        t0 = time.perf_counter()
        hashed = [hash_pool.submit(hash_fn, q) for q in batches]
        reads = [read_pool.submit(to_host, serve(f.result())) for f in hashed]
        out = [f.result() for f in reads]
        seconds = time.perf_counter() - t0
    return seconds, out


def threaded_trial(serve, batches) -> tuple[float, list]:
    """bench.py's 1M / 4M loop (``bench.py:299-309``): every batch
    submitted at once to three threads, each calling ``serve`` (which
    returns host ids). Seconds until the last ids are on the host."""
    with ThreadPoolExecutor(THREADS) as pool:
        t0 = time.perf_counter()
        futures = [pool.submit(serve, b) for b in batches]
        out = [f.result() for f in futures]
        seconds = time.perf_counter() - t0
    return seconds, out


class Bench:
    """One run: the sizes, the device, the seed, and every metric with its
    unit and trial count as the configurations report them. ``answers``,
    when given, receives each configuration's checked inputs and the ids
    served for them (the tests hold them to ``lshrs_tpu``)."""

    def __init__(self, *, sizes: Sizes, device: torch.device, seed: int, answers: dict | None = None):
        self.sizes, self.device, self.seed = sizes, device, seed
        self.answers = answers
        self.metrics: dict = {}
        self.units: dict = {}
        self.trials: dict = {}
        self.extras: dict = {}

    def put(self, name: str, value, unit: str, trials: int | None = None) -> None:
        self.metrics[name], self.units[name] = value, unit
        if trials is not None:
            self.trials[name] = trials

    def rate(self, name: str, work: int, seconds: list, unit: str, *, best: str | None = None) -> None:
        """``work / median(seconds)`` as ``name``, ``work / min(seconds)``
        as ``best`` (default ``<name>_best``)."""
        self.put(name, work / float(np.median(seconds)), unit, len(seconds))
        self.put(best or f"{name}_best", work / min(seconds), unit, len(seconds))

    def record(self, config: str, name: str, **arrays) -> None:
        if self.answers is not None:
            self.answers.setdefault(config, {})[name] = arrays

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, fn) -> float:
        """Seconds of ``fn()``, the device drained on both sides."""
        self.sync()
        t0 = time.perf_counter()
        fn()
        self.sync()
        return time.perf_counter() - t0

    def check_ids(self, name: str, ids: np.ndarray, q: int, n: int) -> None:
        check(ids.shape == (q, TOP_K) and ids.dtype == np.int32, f"{name}_shape",
              (ids.shape, str(ids.dtype)))
        check(bool(((ids >= -1) & (ids < n)).all()), f"{name}_range", "ids out of [-1, n)")

    def check_trials(self, name: str, outs: list, q: int, n: int, *, first: list | None) -> list:
        """Every batch of a trial well formed, and the same ids as the
        first trial's for the same batch (serving is deterministic)."""
        for ids in outs:
            self.check_ids(name, ids, q, n)
        if first is not None:
            same = all(np.array_equal(a, b) for a, b in zip(outs, first))
            check(same, f"{name}_repeatable", "a trial served other ids than the first")
        return outs

    def expect_launches(self, path: str, before: dict, **at_least) -> dict:
        """The launches of each named kernel since ``before``, each at
        least its given count on a device that counts launches; returns
        them (``None`` where launches are not counted)."""
        after = kernel_launches()
        counted = counts_launches(self.device)
        got = {}
        for kernel, n in at_least.items():
            if kernel == "cascade_coarse":  # B2 at the coarse prefix's key packing
                launched = sum(v - before["by_packing"].get(k, 0) for k, v in after["by_packing"].items()
                               if k[0] == CASCADE_BITS and k[1] == CASCADE_BITS)
            else:
                launched = after[kernel] - before[kernel]
            got[kernel] = launched if counted else None
            if counted:
                check(launched >= n, f"{path}_{kernel}_launched",
                      f"{launched} launches, expected at least {n}")
        return got


# -- configurations --------------------------------------------------------


def structured_hasher(device):
    from lshrs_tpu_torch.hash.hasher import LSHHasher

    return LSHHasher(NUM_BANDS, ROWS, DIM, seed=HASH_SEED, hash_family="structured", device=device)


def gaussian_hasher(device):
    from lshrs_tpu_torch.hash.hasher import LSHHasher

    return LSHHasher(NUM_BANDS, ROWS, DIM, seed=HASH_SEED, device=device)


def device_store(b: Bench, capacity: int, **kw):
    from lshrs_tpu_torch import DeviceStore

    return DeviceStore(num_bands=NUM_BANDS, rows_per_band=ROWS, dim=DIM, initial_capacity=capacity,
                       dedupe=False, device=b.device, **kw)


def topk_100k(b: Bench) -> str:
    s = b.sizes
    rng, X = gaussian_rows(b.seed, s.n_100k)
    rows = np.arange(s.n_100k)
    hasher = structured_hasher(b.device)
    store = device_store(b, s.capacity_100k, chunk_size=2048)
    store.add_signature_batch(rows, hasher.hash_batch_dense_host(X))
    serve = store.snapshot_query_fn(TOP_K, wire="dense")
    raw = [rng.standard_normal((s.batch_100k, DIM), dtype=np.float32) for _ in range(s.batches_100k)]

    probe = X[: s.batch_100k]
    got = to_host(serve(hasher.hash_batch_dense_host(probe)))  # warms the batch shape
    b.check_ids("topk_100k", got, s.batch_100k, s.n_100k)
    sm = self_match(got, rows[: s.batch_100k])
    check(sm == 1.0, "self_match_rate", sm)
    b.record("topk_100k", "self", queries=probe, ids=got)

    before = kernel_launches()
    seconds, first = [], None
    for _ in range(s.trials_100k):
        dt, outs = pipelined_trial(hasher.hash_batch_dense_host, serve, raw)
        first = b.check_trials("topk_100k", outs, s.batch_100k, s.n_100k, first=first)
        seconds.append(dt)
    b.extras["launches_topk_100k"] = b.expect_launches(
        "topk_100k", before, **{B1: s.batches_100k * s.trials_100k})
    b.record("topk_100k", "random", queries=raw[0], ids=first[0])

    n_q = s.batches_100k * s.batch_100k
    b.rate("query_qps_100k_d768_p256_top10", n_q, seconds, "qps", best="query_qps_100k_best")
    b.put("latency_ms_per_batch", 1e3 * float(np.median(seconds)) / s.batches_100k, "ms", len(seconds))
    b.put("self_match_rate", sm, "fraction")
    b.put("wire_100k", "dense", "label")
    return "query_qps_100k_d768_p256_top10"


def build_100k(b: Bench) -> str:
    s = b.sizes
    _, X = gaussian_rows(b.seed, s.n_100k)
    rows = np.arange(s.n_100k)

    # Fused device build: the vectors already on the card (uploaded once,
    # untimed), hashed and appended by add_vectors_batch.
    dev_hasher = gaussian_hasher(b.device)
    dev_store = device_store(b, s.capacity_100k, chunk_size=2048)
    x_dev = torch.from_numpy(X).to(b.device)
    proj = dev_hasher.device_projection()
    dev_store.add_vectors_batch(rows, x_dev, proj)  # warm

    def device_build():
        dev_store.clear()
        return b.timed(lambda: dev_store.add_vectors_batch(rows, x_dev, proj))

    b.rate("build_vectors_per_s", s.n_100k, [device_build() for _ in range(s.build_trials)], "vectors/s")
    serve = dev_store.snapshot_query_fn(TOP_K)
    before = kernel_launches()
    got = to_host(serve(dev_hasher.hash_batch_words(x_dev[: s.build_check])))
    b.extras["launches_build_100k"] = b.expect_launches("build_100k", before, **{B1: 1})
    b.check_ids("build_100k", got, s.build_check, s.n_100k)
    sm = self_match(got, rows[: s.build_check])
    check(sm == 1.0, "build_self_match_rate", sm)
    b.put("build_self_match_rate", sm, "fraction")
    del x_dev, dev_store, serve

    # Host-streamed build: structured host hash to the dense wire, then
    # add_signature_batch.
    hasher = structured_hasher(b.device)
    store = device_store(b, s.capacity_100k, chunk_size=2048)
    store.add_signature_batch(rows, hasher.hash_batch_dense_host(X))  # warm

    def stream_build():
        store.clear()
        return b.timed(lambda: store.add_signature_batch(rows, hasher.hash_batch_dense_host(X)))

    b.rate("build_stream_vectors_per_s", s.n_100k, [stream_build() for _ in range(s.stream_trials)],
           "vectors/s")
    got = to_host(store.snapshot_query_fn(TOP_K, wire="dense")(
        hasher.hash_batch_dense_host(X[: s.build_check])))
    sm = self_match(got, rows[: s.build_check])
    check(sm == 1.0, "build_stream_self_match_rate", sm)
    b.put("build_stream_self_match_rate", sm, "fraction")
    return "build_vectors_per_s"


def topk_1m(b: Bench) -> str:
    from lshrs_tpu_torch import LSHRS

    s = b.sizes
    rng, _, chunks = clustered(b.seed, s.n_1m, s.step_1m)
    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                hash_mode="host", hash_family="structured", initial_capacity=s.n_1m,
                dedupe=False, buffer_size=1 << 30, device=b.device,
                # auto ranks by Hamming from 2**19 slots; a smoke-sized
                # store pins the route it would take there.
                engine="hamming" if s.n_1m < 1 << 19 else "auto")
    offsets = range(0, s.n_1m, s.step_1m)
    lsh.index(np.arange(s.step_1m), chunks[0])  # warm the chunk shape
    lsh.clear()

    def build():
        for off, x in zip(offsets, chunks):
            lsh.index(np.arange(off, off + s.step_1m), x)

    build_s = b.timed(build)
    alive = lsh.stats()["index"]["alive"]
    check(alive == s.n_1m, "build_1m_alive", alive)
    b.put("build_1m_s", build_s, "s", 1)
    b.put("build_1m_vectors_per_s", s.n_1m / build_s, "vectors/s", 1)

    serve = lsh.serving_fn(top_k=TOP_K)
    ranking = lsh.stats()["ranking"]
    check(ranking == "hamming", "ranking_1m", ranking)
    keep = chunks[0][: s.batch]
    before = kernel_launches()
    got = serve(keep)
    b.extras["launches_topk_1m_self"] = b.expect_launches("topk_1m", before, **{B2: 1})
    b.check_ids("topk_1m", got, s.batch, s.n_1m)
    sm = self_match(got, np.arange(s.batch))
    check(sm == 1.0, "self_match_rate_1m", sm)
    b.record("topk_1m", "self", queries=keep, ids=got)

    planted = planted_queries(chunks[0][: s.planted_1m])
    truth = exact_top10(planted, chunks, b.device)
    got = serve(planted)
    b.check_ids("topk_1m_planted", got, s.planted_1m, s.n_1m)
    b.record("topk_1m", "planted", queries=planted, ids=got, truth=truth)
    b.put("recall10_1m", recall_at_10(got, truth), "fraction")
    b.put("planted_recall_1m", planted_recall(got), "fraction")

    raw = [rng.standard_normal((s.batch, DIM), dtype=np.float32) for _ in range(s.batches)]
    serve(raw[0])  # warm
    before = kernel_launches()
    seconds, first = [], None
    for _ in range(s.trials):
        dt, outs = threaded_trial(serve, raw)
        first = b.check_trials("topk_1m", outs, s.batch, s.n_1m, first=first)
        seconds.append(dt)
    b.extras["launches_topk_1m"] = b.expect_launches("topk_1m", before, **{B2: s.batches * s.trials})
    b.record("topk_1m", "random", queries=raw[0], ids=first[0])
    b.rate("qps_1m", s.batches * s.batch, seconds, "qps")
    b.put("self_match_rate_1m", sm, "fraction")
    b.put("ranking_1m", ranking, "label")
    b.put("wire_1m", "dense", "label")
    return "qps_1m"


def query_words_4m(b: Bench, hasher) -> list:
    """The 4M rows' query batches: gaussian vectors from
    ``default_rng(seed + 2)`` hashed by the card's gaussian hash, held on
    the host as int32 words (the words wire)."""
    rng = np.random.default_rng(b.seed + 2)
    return [to_host(hasher.hash_batch_words(rng.standard_normal((b.sizes.batch, DIM), dtype=np.float32)))
            for _ in range(b.sizes.batches)]


def on_host(serve):
    return lambda words: to_host(serve(words))


def cascade_4m(b: Bench) -> str:
    s = b.sizes
    hasher = gaussian_hasher(b.device)
    proj = hasher.device_projection()
    store = device_store(b, s.n_4m, enable_hamming=True, hamming_cascade=CASCADE_BITS,
                         hamming_cascade_refine=s.refine_4m)
    for off, x in draw_4m(b.seed, s.draw_4m, s.draw_4m, b.device):  # warm the block shape
        store.add_vectors_batch(np.arange(s.draw_4m), x, proj)
    store.clear()

    probe = []

    def build():  # bench.py times the draw on the card with the build
        for off, x in draw_4m(b.seed, s.n_4m, s.draw_4m, b.device):
            if off == 0:
                probe.append(x[: s.check_4m].clone())
            store.add_vectors_batch(np.arange(off, off + s.draw_4m), x, proj)

    b.put("build_4m_s", b.timed(build), "s", 1)
    serve = on_host(store.snapshot_query_fn(TOP_K, mode="hamming", wire="words"))
    self_words = to_host(hasher.hash_batch_words(probe[0]))
    got = serve(self_words)
    b.check_ids("cascade_4m", got, s.check_4m, s.n_4m)
    sm = self_match(got, np.arange(s.check_4m))
    check(sm == 1.0, "self_match_rate_4m", sm)
    b.record("cascade_4m", "self", words=self_words, ids=got)
    planted_words = to_host(hasher.hash_batch_words(planted_queries(to_host(probe[0]))))
    got = serve(planted_words)
    b.record("cascade_4m", "planted", words=planted_words, ids=got)
    b.put("planted_recall_4m", planted_recall(got), "fraction")

    words = query_words_4m(b, hasher)
    serve(words[0])  # warm
    before = kernel_launches()
    seconds, first = [], None
    for _ in range(s.trials):
        dt, outs = threaded_trial(serve, words)
        first = b.check_trials("cascade_4m", outs, s.batch, s.n_4m, first=first)
        seconds.append(dt)
    b.extras["launches_cascade_4m"] = b.expect_launches(
        "cascade_4m", before, cascade_coarse=s.batches * s.trials)
    b.record("cascade_4m", "random", words=words[0], ids=first[0])
    b.rate("qps_4m", s.batches * s.batch, seconds, "qps")
    b.put("self_match_rate_4m", sm, "fraction")
    b.put("cascade_4m", f"cascade{CASCADE_BITS}:{s.refine_4m}", "label")
    return "qps_4m"


def packed_4m(b: Bench) -> str:
    s = b.sizes
    hasher = gaussian_hasher(b.device)
    stores = {"packed": device_store(b, s.n_4m, enable_hamming=True, hamming_storage="packed"),
              "planes": device_store(b, s.n_4m, enable_hamming=True)}
    probe = None
    # cascade_4m's rows again (the same generator seed), hashed once.
    for off, x in draw_4m(b.seed, s.n_4m, s.draw_4m, b.device):
        if off == 0:
            probe = to_host(x[: s.check_4m])
        words = hasher.hash_batch_words(x)
        for store in stores.values():
            store.add_signature_batch(np.arange(off, off + s.draw_4m), words)
    serves = {name: on_host(store.snapshot_query_fn(TOP_K, mode="hamming", wire="words"))
              for name, store in stores.items()}

    self_words = to_host(hasher.hash_batch_words(probe))
    got = serves["packed"](self_words)
    b.check_ids("packed_4m", got, s.check_4m, s.n_4m)
    sm = self_match(got, np.arange(s.check_4m))
    check(sm == 1.0, "self_match_rate_4m_packed", sm)
    b.record("packed_4m", "self", words=self_words, ids=got)
    planted_words = to_host(hasher.hash_batch_words(planted_queries(probe)))
    got = {name: serve(planted_words) for name, serve in serves.items()}
    check(np.array_equal(got["packed"], got["planes"]), "packed_equals_planes",
          "packed and planes ids differ on the planted queries")
    b.record("packed_4m", "planted", words=planted_words, ids=got["packed"])
    b.put("planted_recall_4m_packed", planted_recall(got["packed"]), "fraction")

    words = query_words_4m(b, hasher)
    kernel = {"packed": B3, "planes": B2}
    for serve in serves.values():
        serve(words[0])  # warm
    seconds = {name: [] for name in serves}
    first = dict.fromkeys(serves)
    launches = dict.fromkeys(serves, 0)
    turns = ["packed", "planes", "planes", "packed"] * s.trials
    for name in turns[: 2 * s.trials]:
        before = kernel_launches()
        dt, outs = threaded_trial(serves[name], words)
        n = b.expect_launches(f"packed_4m_{name}", before, **{kernel[name]: s.batches})[kernel[name]]
        launches[name] = None if n is None else launches[name] + n
        first[name] = b.check_trials(f"packed_4m_{name}", outs, s.batch, s.n_4m, first=first[name])
        seconds[name].append(dt)
    check(all(np.array_equal(a, c) for a, c in zip(first["packed"], first["planes"])),
          "packed_equals_planes_random", "packed and planes ids differ on a timed batch")
    b.record("packed_4m", "random", words=words[0], ids=first["packed"][0])
    b.extras["launches_packed_4m"] = launches
    b.rate("qps_4m_packed", s.batches * s.batch, seconds["packed"], "qps")
    b.rate("qps_4m_planes", s.batches * s.batch, seconds["planes"], "qps")
    b.put("self_match_rate_4m_packed", sm, "fraction")
    return "qps_4m_packed"


def topp_1m_int8(b: Bench) -> str:
    from lshrs_tpu_torch import LSHRS

    s = b.sizes
    rng, centers, chunks = clustered(b.seed, s.n_1m, s.step_1m)  # topk_1m's rows
    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                store_vectors=True, payload_dtype="int8", hash_mode="device",
                initial_capacity=s.n_1m, dedupe=False, device=b.device)
    for off, x in zip(range(0, s.n_1m, s.step_1m), chunks):
        lsh.index(np.arange(off, off + s.step_1m), x)
    queries = []
    for _ in range(s.batches):
        x = centers[rng.integers(0, CENTERS, s.topp_batch)]
        x += NOISE * rng.standard_normal((s.topp_batch, DIM), dtype=np.float32)
        queries.append(x)
    serve = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=s.topp_batch)
    engine = lsh.stats()["index"]["rerank_engine"]

    truth = exact_top10(queries[0], chunks, b.device)
    ids, cos, _ = serve(queries[0])  # warms the batch shape
    b.check_ids("topp_1m_int8", ids, s.topp_batch, s.n_1m)
    served = ids >= 0
    check(bool(np.isfinite(cos[served]).all() and (np.abs(cos[served]) <= 1 + 1e-5).all()),
          "topp_1m_int8_cosines", "a served cosine is not finite or outside [-1, 1]")
    b.record("topp_1m_int8", "clustered", queries=queries[0], ids=ids, truth=truth)
    b.put("recall10_1m_reranked", recall_at_10(ids, truth), "fraction")

    before = kernel_launches()
    seconds, first = [], None
    for _ in range(s.trials):
        dt, outs = threaded_trial(serve, queries)
        first = b.check_trials("topp_1m_int8", [o[0] for o in outs], s.topp_batch, s.n_1m, first=first)
        seconds.append(dt)
    # The gather engine ranks its candidates by kernel B1; the full
    # engine counts collisions in plain torch and launches no kernel.
    need = {B1: s.batches * s.trials} if engine == "gather" else {}
    launched = b.expect_launches("topp_1m_int8", before, **need)
    b.put("b1_launches_topp_1m", launched.get(B1), "launches")
    b.rate("qps_1m_reranked", s.batches * s.topp_batch, seconds, "qps")
    b.put("rerank_engine_1m", engine, "label")
    return "qps_1m_reranked"


# Each configuration's run, in the order of ``--config all``; each returns
# its headline metric's name.
RUNS = {"topk_100k": topk_100k, "build_100k": build_100k, "topk_1m": topk_1m,
        "cascade_4m": cascade_4m, "packed_4m": packed_4m, "topp_1m_int8": topp_1m_int8}
CONFIGS = tuple(RUNS)


# -- the run ---------------------------------------------------------------


def card(device: torch.device) -> dict:
    """``nvidia-smi``'s name and power limit of the card (``None`` on the
    CPU)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    name, limit = (f.strip() for f in out.stdout.strip().splitlines()[0].rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def setup(device: torch.device) -> dict:
    """Build the CUDA kernels (on the card) and load the native host FWHT,
    timed apart from every configuration."""
    from lshrs_tpu_torch.native.build import load_fwht_library, native_status

    t0 = time.perf_counter()
    if device.type == "cuda":
        from lshrs_tpu_torch.ops import _build

        _build.library()
    load_fwht_library()
    status = native_status()
    # The host-hash rows measure the C FWHT, as bench.py's did.
    check(status.startswith("loaded"), "native_fwht", status)
    return {"setup_s": time.perf_counter() - t0, "native_fwht": status}


def run(bench: Bench, configs) -> dict:
    """Every configuration in turn; returns the stdout line."""
    dev = bench.device
    bench.extras.update(setup(dev))
    headline = None
    for name in configs:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        metric = RUNS[name](bench)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        bench.extras[f"seconds_{name}"] = seconds
        bench.extras[f"peak_device_bytes_{name}"] = peak
        headline = headline or metric
        print(json.dumps({"config": name, "seconds": seconds, "peak_device_bytes": peak,
                          "headline": metric, "value": bench.metrics[metric]}), file=sys.stderr, flush=True)
    value, unit = bench.metrics[headline], bench.units[headline]
    return {
        "metric": headline,
        "value": value,
        "unit": unit,
        "vs_baseline": value / BASELINE_QPS if unit == "qps" else None,
        "extras": {
            **bench.metrics,
            **bench.extras,
            "units": bench.units,
            "trials": bench.trials,
            "seed": bench.seed,
            "smoke": bench.sizes is SMOKE,
            "vs_baseline_is": f"{headline} / {BASELINE_QPS:.0f} QPS (bench.py's BASELINE_QPS)",
            "device": card(dev),
            "torch": torch.__version__,
        },
    }


def main(argv=None, *, answers: dict | None = None) -> int:
    start = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=("all",) + CONFIGS, default="all")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--smoke", action="store_true", help="small sizes, every width and route kept")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_cuda: no CUDA device available (--device cpu runs the plain versions)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = Bench(sizes=SMOKE if args.smoke else FULL, device=device, seed=args.seed, answers=answers)
    configs = CONFIGS if args.config == "all" else (args.config,)
    try:
        line = run(bench, configs)
    except CheckFailed as exc:
        print(json.dumps({"check_failed": exc.name, "detail": str(exc.detail)}), file=sys.stderr)
        return 1
    line["extras"]["run_s"] = time.perf_counter() - start
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
