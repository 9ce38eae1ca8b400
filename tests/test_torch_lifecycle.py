"""The lifecycle surface: close, the context manager, __repr__, the
``lshrs`` alias and ``__version__``, as the reference package has them."""

from __future__ import annotations

import numpy as np
import pytest

import lshrs_tpu
import lshrs_tpu_torch
from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch.storage.device import DeviceStore

KW = dict(dim=4, num_bands=2, rows_per_band=2, num_perm=4, hash_mode="host")


def _closing(lsh):
    """Record the store's close calls, then run the real one."""
    calls = []
    real = lsh._storage.close

    def close():
        calls.append(len(lsh._storage))
        real()

    lsh._storage.close = close
    return calls


def test_close_flushes_buffer():
    lsh = TorchLSHRS(buffer_size=100, device="cpu", **KW)
    lsh.ingest(0, np.ones(4, np.float32))
    assert len(lsh._storage) == 0  # still buffered
    calls = _closing(lsh)
    lsh.close()
    assert calls == [1]  # flushed before the store was released
    assert lsh.stats()["counters"]["flushes"] == 1


def test_context_manager_flushes_on_exit():
    with TorchLSHRS(device="cpu", **KW) as lsh:
        calls = _closing(lsh)
        lsh.ingest(3, np.ones(4, np.float32))
    assert calls == [1]
    assert lsh._storage._sig_t is None


def test_context_manager_closes_on_error():
    with pytest.raises(KeyError):
        with TorchLSHRS(device="cpu", **KW) as lsh:
            raise KeyError("boom")
    assert lsh._storage._ids is None


@pytest.mark.parametrize("store_vectors", [False, True])
def test_device_store_close_drops_its_tensors(store_vectors, rng):
    st = DeviceStore(num_bands=2, rows_per_band=8, dim=4, store_vectors=store_vectors,
                     payload_dtype="int8", enable_hamming=True, device="cpu")
    st.add_signature_batch([1, 2], np.zeros((2, 2), np.uint32),
                           rng.standard_normal((2, 4)).astype(np.float32))
    st.query_hamming(np.zeros((1, 2), np.uint32), 1)  # planes and refine table built
    assert st._planes is not None and st._refine is not None
    st.close()
    for name in ("_sig_t", "_sig_rows", "_ids", "_tie", "_planes", "_refine", "_payload",
                 "_pnorm", "_pscale"):
        assert getattr(st, name) is None, name


def test_repr_matches_the_reference():
    kw = dict(dim=8, num_perm=16, num_bands=4, rows_per_band=4)
    for engine in ("auto", "collision", "hamming"):
        assert repr(TorchLSHRS(engine=engine, device="cpu", **kw)) == repr(
            JaxLSHRS(engine=engine, **kw))
    pinned = TorchLSHRS(initial_capacity=1 << 19, device="cpu", **kw)
    pinned._use_hamming_ranking()
    assert repr(pinned).endswith("engine='auto->hamming', backend='device')")


def test_alias_and_version():
    assert lshrs_tpu_torch.lshrs is lshrs_tpu_torch.LSHRS
    assert lshrs_tpu_torch.__version__ == lshrs_tpu.__version__
    assert isinstance(lshrs_tpu_torch.__version__, str)
    assert {"lshrs", "__version__"} <= set(lshrs_tpu_torch.__all__)
