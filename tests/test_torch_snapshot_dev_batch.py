"""``DeviceStore.snapshot_query_fn(k, dev_batch=d)``: the port against `lshrs_tpu`.

The reference's serving closure optionally serves a batch in slices of
``dev_batch`` queries. The port's takes the same argument; the same words
(or quantised coordinates) go through both packages' closures at the same
``d`` and the ids must be IDENTICAL, for ``d`` in {None, 1, 3 (ragged), Q}
and every mode, wire and probe depth: collision at probes 1 and 2, Hamming
on planes and on packed words, asymmetric on the int8 and the int4 wire,
the cascade, and a ``where=`` filter.
"""

from __future__ import annotations

import numpy as np
import pytest

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops import asymmetric as jasym
from lshrs_tpu.storage import IdFilter as JaxFilter
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch import IdFilter
from lshrs_tpu_torch.ops import asymmetric as tasym
from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

B, R, D = 8, 16, 32  # 128 bits: room for a 32-bit cascade prefix
N, Q, K = 220, 7, 6
KW = dict(num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=256, group_size=8,
          enable_hamming=True)
DEV_BATCHES = [None, 1, 3, Q]

# (store options, closure options, what the closure is fed)
CASES = {
    "collision": ({}, dict(mode="collision"), "words"),
    "collision_probes2": ({}, dict(mode="collision", probes=2), "probe_words"),
    "collision_where": ({}, dict(mode="collision"), "words"),
    "hamming_planes": ({}, dict(mode="hamming"), "words"),
    "hamming_packed": ({"hamming_storage": "packed"}, dict(mode="hamming"), "words"),
    "hamming_where": ({}, dict(mode="hamming"), "words"),
    "asymmetric_words": ({}, dict(mode="asymmetric"), "coords"),
    "asymmetric_coords4": ({}, dict(mode="asymmetric", wire="coords4"), "coords4"),
    "cascade": ({"hamming_cascade": 32, "hamming_cascade_refine": 64}, dict(mode="hamming"),
                "words"),
    "cascade_where": ({"hamming_cascade": 32, "hamming_cascade_refine": 64},
                      dict(mode="hamming"), "words"),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    h = LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)
    X = rng.standard_normal((N, D)).astype(np.float32)
    ids = rng.permutation(10_000)[:N]
    qx = X[:Q] + 0.4 * rng.standard_normal((Q, D)).astype(np.float32)
    coords = jasym.quantize_coords_np(h.hash_batch_coords_host(qx))[0]
    coords4 = jasym.quantize_coords_np(h.hash_batch_coords_host(qx), qmax=jasym.QMAX4)[0]
    return {
        "ids": ids,
        "words": h.hash_batch_words_host(X),
        "inputs": {
            "words": h.hash_batch_words_host(qx),
            "probe_words": h.hash_batch_probe_words_host(qx, 2),
            "coords": coords,
            "coords4": tasym.pack_coords_int4_np(coords4),
        },
    }


@pytest.mark.parametrize("dev_batch", DEV_BATCHES)
@pytest.mark.parametrize("case", list(CASES))
def test_dev_batch_ids_equal_the_reference(data, case, dev_batch):
    store_kw, fn_kw, feed = CASES[case]
    js, ts = JaxStore(**KW, **store_kw), TorchStore(device="cpu", **KW, **store_kw)
    for s in (js, ts):
        s.add_signature_batch(data["ids"], data["words"])
    jw = tw = None
    if case.endswith("_where"):
        allowed = np.sort(data["ids"])[::2]
        jw = JaxFilter(allowed_ids=allowed, disallowed_ids=[int(allowed[0])])
        tw = IdFilter(allowed_ids=allowed, disallowed_ids=[int(allowed[0])])
    q = data["inputs"][feed]
    want = np.asarray(js.snapshot_query_fn(K, dev_batch=dev_batch, where=jw, **fn_kw)(q))
    got = ts.snapshot_query_fn(K, dev_batch=dev_batch, where=tw, **fn_kw)(q)
    assert tuple(got.shape) == (Q, K)
    np.testing.assert_array_equal(got.numpy(), want)
    # Slicing never changes an answer: equal to the unsliced closure too.
    whole = ts.snapshot_query_fn(K, where=tw, **fn_kw)(q)
    np.testing.assert_array_equal(got.numpy(), whole.numpy())


@pytest.mark.parametrize("dev_batch", [0, -2])
def test_dev_batch_must_be_positive(data, dev_batch):
    ts = TorchStore(device="cpu", **KW)
    ts.add_signature_batch(data["ids"], data["words"])
    with pytest.raises(ValueError, match="dev_batch"):
        ts.snapshot_query_fn(K, dev_batch=dev_batch)


def test_dev_batch_closure_goes_stale(data):
    ts = TorchStore(device="cpu", **KW)
    ts.add_signature_batch(data["ids"], data["words"])
    serve = ts.snapshot_query_fn(K, mode="hamming", dev_batch=2)
    serve(data["inputs"]["words"])
    ts.remove_indices([int(data["ids"][0])])
    with pytest.raises(RuntimeError, match="stale"):
        serve(data["inputs"]["words"])
