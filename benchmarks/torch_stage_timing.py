"""What the port's stage profiles share: timing, checks, launch counters.

Imported by ``benchmarks/torch_kernel_profile.py``,
``torch_hamming_profile.py``, ``torch_cascade_profile.py``,
``torch_ingest_profile.py`` and ``torch_gather_rerank_bench.py``, and by
the serving benches ``torch_{asymmetric,scale,rerank,auto_engine,cp}_bench.py``;
not a script of its own.

Timing (:func:`stage_ms`): a stage's inputs are computed before it is
timed; the stage is called once to warm it up, then ``n_iter`` times back
to back between two CUDA events, ``trials`` times; the result is the
median over the trials of the ms per call. The host's clock is read
around the same calls: ``issue_ms``, the host's time to enqueue a call
(to the end of the loop, before any synchronize), and ``wall_ms``, to
after the synchronize. Where ``issue_ms`` comes near ``ms`` the card
waited on the host's launches, and ``ms`` is an upper bound on the
card's own time. On the CPU all three are the host's clock and mean
nothing for the card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B1, B2, B3 = "group_max_keys", "hamming_group_max_keys", "hamming_packed_group_max_keys"


class CheckFailed(Exception):
    """A check of the run failed: the run exits 1 and names it."""

    def __init__(self, name: str, detail):
        super().__init__(f"{name}: {detail}")
        self.name, self.detail = name, detail


def check(ok: bool, name: str, detail) -> None:
    if not ok:
        raise CheckFailed(name, detail)


def run_checked(body, *args) -> int:
    """``body(*args)``, returning 0; a :class:`CheckFailed` prints
    ``{"check_failed": ...}`` on stderr and returns 1."""
    try:
        body(*args)
    except CheckFailed as exc:
        print(json.dumps({"check_failed": exc.name, "detail": str(exc.detail)}), file=sys.stderr)
        return 1
    return 0


def resolve_device(name: str, script: str) -> torch.device | None:
    """``torch.device(name)`` with TF32 matmuls off and the kernels built on
    a card; ``None`` (after a line on stderr) when no card is available."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{script}: no CUDA device available (--device cpu runs the plain versions)",
              file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        from lshrs_tpu_torch.ops import _build

        _build.library()
    return device


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


def counts_launches(device: torch.device) -> bool:
    """Whether the kernel wrappers count launches on ``device`` (on CPU
    tensors their plain versions run and nothing is counted)."""
    return device.type == "cuda"


def launch_counts() -> dict:
    """The kernel wrappers' launch counters, B2's also by key packing
    ``(operand width, offset, shift)``."""
    from lshrs_tpu_torch.ops import group_max as gm

    return {
        B1: gm.group_max_keys.launches,
        B2: gm.hamming_group_max_keys.launches,
        B3: gm.hamming_packed_group_max_keys.launches,
        "by_packing": dict(gm.hamming_group_max_keys.launches_by_packing),
    }


def launch_delta(before: dict) -> dict:
    """Launches since ``before`` (:func:`launch_counts`), B2's by packing
    as ``"width/offset/shift"`` keys."""
    after = launch_counts()
    out = {k: after[k] - before[k] for k in (B1, B2, B3)}
    out["b2_by_packing"] = {
        "/".join(map(str, key)): n - before["by_packing"].get(key, 0)
        for key, n in sorted(after["by_packing"].items()) if n != before["by_packing"].get(key, 0)
    }
    return out


def expect_launches(name: str, got: dict | None, device: torch.device, *, b1: int = 0,
                    b2: int = 0, b3: int = 0, b2_width: int | None = None,
                    b2_packing: tuple | None = None) -> None:
    """On a device that counts launches: B1, B2 and B3 moved by exactly
    ``b1``, ``b2`` and ``b3``, every B2 launch was at ``b2_width`` operand
    columns when that is given, and at the key packing ``b2_packing``
    ``(width, offset, shift)`` when that is given."""
    if not counts_launches(device):
        return
    for kernel, n in ((B1, b1), (B2, b2), (B3, b3)):
        check(got[kernel] == n, f"{name}_launches", {"kernel": kernel, "want": n, "got": got})
    if b2_width is not None:
        widths = {int(k.split("/")[0]) for k in got["b2_by_packing"]}
        check(widths <= {b2_width}, f"{name}_launches_b2_width", {"want": b2_width, "got": got})
    if b2_packing is not None and b2:
        want = {"/".join(map(str, b2_packing)): b2}
        check(got["b2_by_packing"] == want, f"{name}_launches_b2_packing",
              {"want": want, "got": got})


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    """Start :func:`peak_bytes` from what is allocated now."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int | None:
    """``torch.cuda.max_memory_allocated`` on a card, ``None`` on the CPU."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def platform(device: torch.device) -> str:
    """What the reference's ``jax.devices()[0].platform`` field becomes."""
    return "gpu" if device.type == "cuda" else "cpu"


def to_host(t) -> np.ndarray:
    """A NumPy copy of a tensor on any device (the completion barrier of a
    read), or ``t`` as an array."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def check_ids(name: str, ids: np.ndarray, q: int, k: int, n: int) -> None:
    """``ids`` is ``(q, k)`` and every entry is -1 or a stored id in ``[0, n)``."""
    check(ids.shape == (q, k), f"{name}_shape", ids.shape)
    check(bool(((ids >= -1) & (ids < n)).all()), f"{name}_range", "ids out of [-1, n)")


def smoke_sizes(ap, args, sizes: dict) -> None:
    """``--smoke``: each of ``sizes`` replaces its flag where the flag was
    left at its default."""
    for key, value in sizes.items():
        if getattr(args, key) == ap.get_default(key):
            setattr(args, key, value)


def pipelined_trial(prep, serve, read, batches: list) -> tuple[float, list]:
    """One trial of the serving benches' pipeline: a hasher thread runs
    ``prep`` on each batch, this thread calls ``serve`` on each prepared
    batch in order, a reader thread runs ``read`` (the completion barrier)
    on each output. Returns the seconds and the reads, in order."""
    with ThreadPoolExecutor(max_workers=1) as hash_pool, \
            ThreadPoolExecutor(max_workers=1) as read_pool:
        t0 = time.perf_counter()
        hashed = [hash_pool.submit(prep, b) for b in batches]
        reads = [read_pool.submit(read, serve(f.result())) for f in hashed]
        out = [f.result() for f in reads]
        return time.perf_counter() - t0, out


def pooled_trial(serve, batches: list, read=to_host, workers: int = 3) -> tuple[float, list]:
    """One trial with ``workers`` threads each calling ``serve`` on batches
    (dispatches serialise on the store's lock); this thread reads each
    output with ``read``. Returns the seconds and the reads, in order."""
    with ThreadPoolExecutor(max_workers=workers) as pool:
        t0 = time.perf_counter()
        futs = [pool.submit(serve, b) for b in batches]
        out = [read(f.result()) for f in futs]
        return time.perf_counter() - t0, out


def repeated_trials(trial, trials: int, *, q: int, k: int, n: int,
                    ids_of=lambda out: out) -> tuple[list[float], list]:
    """Run ``trial()`` (seconds, outputs) ``trials`` times. Each output's ids
    (``ids_of``) are checked (:func:`check_ids`), and every trial must serve
    the ids of the first. Returns the trials' seconds, sorted, and the
    first's outputs."""
    ts, first, first_ids = [], None, None
    for _ in range(trials):
        dt, out = trial()
        ids = [ids_of(o) for o in out]
        for batch in ids:
            check_ids("timed", batch, q, k, n)
        if first is None:
            first, first_ids = out, ids
        check(all(np.array_equal(a, b) for a, b in zip(ids, first_ids)), "timed_repeatable",
              "a trial served other ids than the first")
        ts.append(dt)
    return sorted(ts), first


def device_ms_per_call(fn, device: torch.device) -> float:
    """:func:`stage_ms` of a serving call on inputs already on the card
    (4 calls a trial, 3 trials): what the card takes a batch, to hold
    against the host's wall clock per batch."""
    return stage_ms(fn, n_iter=4, trials=3, device=device)["ms"]


def stage_ms(fn, *, n_iter: int, trials: int, device: torch.device) -> dict:
    """Time ``fn()``: one warm-up call, then ``trials`` runs of ``n_iter``
    back-to-back calls. Returns ``ms`` (the median of the trials' ms per
    call by CUDA events; the host's clock on the CPU), ``issue_ms`` and
    ``wall_ms`` (the same by the host's clock, to the end of the loop and
    to after a synchronize), ``calls`` (every call made, the warm-up's
    included) and ``out`` (the warm-up's result)."""
    out = fn()
    sync(device)
    cuda = device.type == "cuda"
    dev_ms, issue_ms, wall_ms = [], [], []
    for _ in range(trials):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            fn()
        issued = time.perf_counter() - t0
        if cuda:
            end.record()
            end.synchronize()
        wall = time.perf_counter() - t0
        dev_ms.append(start.elapsed_time(end) / n_iter if cuda else 1000 * wall / n_iter)
        issue_ms.append(1000 * issued / n_iter)
        wall_ms.append(1000 * wall / n_iter)
    return {"ms": float(np.median(dev_ms)), "issue_ms": float(np.median(issue_ms)),
            "wall_ms": float(np.median(wall_ms)), "calls": 1 + trials * n_iter, "out": out}


def timed_row(metric: str, label: str, fn, *, device: torch.device, n_iter: int, trials: int,
              dev_card: dict, q: int | None = None, per_call: dict | None = None,
              **fields) -> dict:
    """Time ``fn`` (:func:`stage_ms`), print its JSON row and hold its
    launches: ``per_call`` gives each kernel's launches per call (``b1``,
    ``b2``, ``b3``; the others must stay 0) and optionally ``b2_width``.
    Returns the timing (its ``out`` is the warm-up call's result) with the
    row's ``label`` and ``fields``."""
    before = launch_counts()
    t = stage_ms(fn, n_iter=n_iter, trials=trials, device=device)
    got = launch_delta(before) if counts_launches(device) else None
    row = {"metric": metric, "label": label, **fields, "ms": t["ms"],
           "issue_ms": t["issue_ms"], "wall_ms": t["wall_ms"], "n_iter": n_iter, "trials": trials}
    if q and t["ms"] > 0:
        row["qps"] = 1000 * q / t["ms"]
    emit({**row, "launches": got, "device": dev_card})
    want = dict(per_call or {})
    width = want.pop("b2_width", None)
    expect_launches(label, got, device, b2_width=width,
                    **{k: n * t["calls"] for k, n in want.items()})
    return {**t, "label": label, **fields}


def chunk_seed(seed: int, off: int) -> int:
    """The generator seed of the rows drawn at row ``off``."""
    return int(np.random.SeedSequence([seed, off]).generate_state(1, np.uint64)[0])


def draw_rows(seed: int, off: int, n: int, dim: int, device: torch.device) -> torch.Tensor:
    """``n`` standard-normal float32 rows of ``dim`` drawn on ``device``:
    the same rows for the same ``(seed, off)``, whatever came before (the
    capacity bench's draws)."""
    gen = torch.Generator(device=device).manual_seed(chunk_seed(seed, off))
    return torch.randn((n, dim), generator=gen, device=device)


def same(a, b) -> bool:
    """Tensors (or tuples of them) equal bit for bit."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)
