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
multi-probe querying, ``where=`` id filters, delete and compact, and
checkpoints in the reference package's format. CUDA kernels build with
``nvcc`` at first use; on CPU tensors their plain PyTorch versions run.
"""

from lshrs_tpu_torch.core.main import LSHRS
from lshrs_tpu_torch.storage import BaseStorage, DeviceStore, IdFilter, MemoryStorage

__all__ = ["LSHRS", "BaseStorage", "DeviceStore", "IdFilter", "MemoryStorage"]
