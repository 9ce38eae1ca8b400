"""The port's spans (`lshrs_tpu_torch.utils.trace`): what a profiler
records of a served batch and of an index build, nested and in order, the
lazily built tables paid for by the first query only, and no
``record_function`` at all while no profiler collects.

The ``cuda`` case holds every device operation of a served batch to the
span that launched it, on the trace's clock."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lshrs_tpu_torch import LSHRS
from lshrs_tpu_torch.utils import trace

DIM, N, Q = 32, 3000, 40

# Route -> (the closure's spans in order, the engine's spans in order on
# the first call after an index, and on every later call).
ROUTES = {
    "hamming": (
        ["lshrs.store.ranks", "lshrs.store.refine_table", "lshrs.store.planes",
         "lshrs.b2", "lshrs.select", "lshrs.refine", "lshrs.topk"],
        ["lshrs.b2", "lshrs.select", "lshrs.refine", "lshrs.topk"],
    ),
    "collision": (
        ["lshrs.store.ranks", "lshrs.store.refine_table",
         "lshrs.b1", "lshrs.select", "lshrs.refine", "lshrs.topk"],
        ["lshrs.b1", "lshrs.select", "lshrs.refine", "lshrs.topk"],
    ),
}
CLOSURE = ["lshrs.validate", "lshrs.hash", "lshrs.engine", "lshrs.download"]
LAZY = {"lshrs.store.ranks", "lshrs.store.refine_table", "lshrs.store.planes"}


def _index(engine: str, device="cpu", n: int = N, initial_capacity: int = 1024,
           shards=None) -> tuple:
    x = np.random.default_rng(5).standard_normal((n, DIM)).astype(np.float32)
    lsh = LSHRS(dim=DIM, num_perm=64, num_bands=8, rows_per_band=8, engine=engine,
                initial_capacity=initial_capacity, shards=shards, device=device)
    return lsh, x


def _tree(prof) -> list:
    """The ``lshrs.*`` spans of a finished profiler as nested
    ``[name, start_ns, end_ns, children]``, in time order."""
    spans = sorted(((ev.start_ns(), -ev.end_ns(), ev.name())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name().startswith("lshrs.")))
    roots: list = []
    stack: list = []
    for s, neg_e, name in spans:
        while stack and stack[-1][2] < s:
            stack.pop()
        node = [name, s, -neg_e, []]
        (stack[-1][3] if stack else roots).append(node)
        stack.append(node)
    return roots


def _names(nodes) -> list[str]:
    return [n[0] for n in nodes]


def _child(node, name):
    return next(c for c in node[3] if c[0] == name)


@pytest.mark.parametrize("engine", sorted(ROUTES))
def test_a_served_batch_records_its_spans_nested_and_in_order(engine):
    lsh, x = _index(engine)
    lsh.index(np.arange(N), x)
    serve = lsh.serving_fn(top_k=5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = serve(x[:Q])
        later = [serve(x[Q : 2 * Q]), serve(x[:Q])]
    np.testing.assert_array_equal(first, later[1])
    roots = _tree(prof)
    assert _names(roots) == ["lshrs.serve"] * 3
    on_first, on_later = ROUTES[engine]
    for i, call in enumerate(roots):
        assert _names(call[3]) == CLOSURE
        engine_span = _child(call, "lshrs.engine")
        assert _names(engine_span[3]) == (on_first if i == 0 else on_later)
        assert all(not c[3] for c in engine_span[3] if c[0] not in LAZY)
        for c in call[3]:
            assert call[1] <= c[1] <= c[2] <= call[2]


@pytest.mark.parametrize("shards", [None, 2])
def test_an_index_records_append_and_growth_and_the_first_query_the_lazy_tables(shards):
    # Two CPU shards start at 2 x 2,048 slots: 5,000 rows make them grow.
    n = N if shards is None else 5000
    lsh, x = _index("hamming", n=n, initial_capacity=256, shards=shards)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lsh.index(np.arange(n), x)
    (index,) = _tree(prof)
    assert index[0] == "lshrs.index"
    assert _names(index[3]) == ["lshrs.index.validate", "lshrs.hash",
                                "lshrs.store.upsert_check", "lshrs.store.append"]
    assert _names(_child(index, "lshrs.store.append")[3]) == ["lshrs.store.grow"]
    serve = lsh.serving_fn(top_k=5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(x[:Q])
    first = {n for n in _names(_child(_tree(prof)[0], "lshrs.engine")[3])}
    assert LAZY <= first
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(x[:Q])
    second = {n for n in _names(_child(_tree(prof)[0], "lshrs.engine")[3])}
    assert not LAZY & second
    # An index that fits the capacity appends without growing.
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lsh.index(np.arange(n, n + 10), x[:10])
    (index,) = _tree(prof)
    assert _names(_child(index, "lshrs.store.append")[3]) == []


@pytest.mark.parametrize("shards", [None, 2])
def test_a_blocked_or_sharded_store_merges_inside_the_engine(shards, monkeypatch):
    """Past one B2 launch's key ceiling (the block size patched down to
    1,024 slots: three blocks of a 4,096-slot store) the engine runs B2 and
    the selection tail once a block, then ``lshrs.merge``; a sharded store
    merges its shards' lists in the same span."""
    import lshrs_tpu_torch.storage.device as device_mod

    from lshrs_tpu_torch.ops import hamming as tham

    if shards is None:
        monkeypatch.setattr(device_mod, "hamming_block_slots", lambda p: 1024)
    calls = {"hamming_group_max_keys": 0, "hamming_refine_topk": 0}

    def spy(name):
        real = getattr(tham, name)

        def call(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)

        monkeypatch.setattr(tham, name, call)

    for name in calls:
        spy(name)
    lsh, x = _index("hamming", initial_capacity=1024, shards=shards)
    lsh.index(np.arange(N), x)
    serve = lsh.serving_fn(top_k=5)
    serve(x[:Q])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(x[:Q])
    (call,) = _tree(prof)
    assert _names(call[3]) == CLOSURE
    engine_span = _child(call, "lshrs.engine")
    parts = 3 if shards is None else 2
    assert _names(engine_span[3]) == ROUTES["hamming"][1] * parts + ["lshrs.merge"]
    merge = engine_span[3][-1]
    assert engine_span[1] <= merge[1] <= merge[2] <= engine_span[2] and not merge[3]
    # B2 and the kernel's wrapper once a block or shard, in each of two calls.
    assert calls == {"hamming_group_max_keys": 2 * parts, "hamming_refine_topk": 2 * parts}


@pytest.mark.parametrize("mode", ["asymmetric", "topp"])
def test_the_other_closures_record_the_same_spans(mode):
    lsh = LSHRS(dim=DIM, num_perm=64, num_bands=8, rows_per_band=8, engine="hamming",
                store_vectors=mode == "topp", rerank_engine="gather", device="cpu")
    x = np.random.default_rng(6).standard_normal((N, DIM)).astype(np.float32)
    lsh.index(np.arange(N), x)
    serve = lsh.serving_fn(top_k=5, mode=mode)
    serve(x[:Q])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(x[:Q])
    (call,) = _tree(prof)
    assert call[0] == "lshrs.serve" and _names(call[3]) == CLOSURE
    inner = _names(_child(call, "lshrs.engine")[3])
    assert {"lshrs.select", "lshrs.refine"} <= set(inner)
    assert ("lshrs.b2" if mode == "asymmetric" else "lshrs.b1") in inner


def test_without_a_profiler_no_record_function_is_made(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function made with no profiler collecting")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert trace.span("lshrs.serve") is trace._OFF
    assert trace.span("lshrs.hash") is trace.span("lshrs.topk")
    lsh, x = _index("hamming", initial_capacity=256)
    lsh.index(np.arange(N), x)
    serve = lsh.serving_fn(top_k=5)
    assert serve(x[:Q]).shape == (Q, 5)
    assert lsh.stats()["counters"]["queries_served"] == Q


@pytest.mark.cuda
def test_every_device_op_of_a_served_batch_lies_in_a_span_that_launched_it():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (kernels B1/B2/B3 have no CPU build)")
    lsh, x = _index("hamming", device="cuda", n=20000)
    lsh.index(np.arange(len(x)), x)
    serve = lsh.serving_fn(top_k=10)
    serve(x[:500])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve(x[:500])
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    spans = [(ev.start_ns(), ev.end_ns(), ev.name()) for ev in events
             if ev.device_type() == DeviceType.CPU and ev.name().startswith("lshrs.")]
    launches = {ev.correlation_id(): ev.start_ns() for ev in events
                if ev.device_type() == DeviceType.CPU and ev.name().startswith("cu")}
    device = [ev for ev in events
              if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation()]
    assert device and any(n == "lshrs.b2" for _, _, n in spans)
    for ev in device:
        at = launches.get(ev.correlation_id())
        assert at is not None, ev.name()
        covering = [(s, e, n) for s, e, n in spans if s <= at <= e]
        assert covering, ev.name()
        innermost = max(covering, key=lambda sp: sp[0])
        assert ev.start_ns() >= innermost[0], (ev.name(), innermost[2])


def test_the_span_cost_script_runs_on_the_cpu(capsys):
    import importlib.util
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "benchmarks" / "torch_span_cost.py"
    spec = importlib.util.spec_from_file_location("torch_span_cost", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = script.main(calls=2000)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["guard_ns"] > 0 and out["span_off_ns"] > 0 and out["record_function_off_ns"] > 0
    # Where CUDA is there, emit_nvtx() turns the spans on.
    assert out.get("nvtx_on") is (True if torch.cuda.is_available() else None)
    assert not torch.autograd._profiler_enabled()
