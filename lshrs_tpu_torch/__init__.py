"""lshrs_tpu_torch — the PyTorch + CUDA port of ``lshrs_tpu``.

Banded random-projection LSH index and query engine on PyTorch tensors,
with hand-written CUDA kernels for Hopper on the query hot path. This
package imports ``torch`` and NumPy, never JAX or ``lshrs_tpu``; the
reference package stays beside it and the tests hold the two to the same
results.

Ported so far: the device store's build and exact top-k serving path —
band-collision ranking (kernel B1) and full-signature Hamming ranking on
int8 bitplanes (kernel B2) or on the packed words (kernel B3) — top-p
cosine rerank over a resident payload, the gaussian, structured (FWHT,
with a native C host path), learned and cross-polytope hash families,
multi-probe querying, ``where=`` id filters, asymmetric ranking of
quantised query coordinates and the Hamming refinement cascade (which
serves stores past the int32 key ceiling), delete and compact, bucketed
queries, in-place retuning, maximum inner-product search, and checkpoints
in the reference package's format. CUDA kernels build with ``nvcc`` at
first use; on CPU tensors their plain PyTorch versions run.

Bulk ingestion: ``LSHRS.create_signatures`` streams ``(ids, vectors)``
batches from NumPy arrays and ``.npy`` / ``.npz`` files, Parquet or
Postgres (`lshrs_tpu_torch.io`) through a prefetch thread and a two-stage
pipeline. The bucket backends of the reference run on the host:
``backend="memory"`` (`MemoryStorage`), ``backend="redis"``
(`lshrs_tpu_torch.storage.RedisStorage`) and any ``storage=``.
Sharding: ``LSHRS(shards=N)`` and `lshrs_tpu_torch.parallel`
(``make_mesh``, ``ShardedDeviceStore``) split the slots over devices, or
over one card repeated, and merge every shard's exact top-k.
Past the grouped engines' int32 key ceiling of a store or a shard, with
more than 64 bands or below the group size, queries rank through the
chunked fallbacks (`lshrs_tpu_torch.ops.scan.collision_topk_core` and the
Hamming and asymmetric chunked cores), as the reference's do.
"""

import importlib.metadata
from typing import Final

from lshrs_tpu_torch.core.main import LSHRS, lshrs
from lshrs_tpu_torch.storage import BaseStorage, DeviceStore, IdFilter, MemoryStorage

# The installed distribution's version (both packages ship in it), or
# "0.0.0" in a checkout that is not installed.
try:
    _version = importlib.metadata.version("lshrs-tpu")
except importlib.metadata.PackageNotFoundError:  # pragma: no cover
    _version = "0.0.0"
__version__: Final[str] = _version
del _version

__all__ = [
    "LSHRS",
    "lshrs",
    "BaseStorage",
    "DeviceStore",
    "IdFilter",
    "MemoryStorage",
    "__version__",
]
