"""Seeded data for the cells: ann-benchmarks' shapes, synthetic vectors.

Frozen copy of the clustered recipe of ``bench_cuda.py:172-200``
(``clustered``: rows around 4,096 gaussian centres with 0.35 gaussian
noise), drawn on the device with a ``torch.Generator`` in a few large
calls instead of NumPy chunks: the same distribution, not the same
numbers. Rows are scaled to unit norm, as ann-benchmarks stores its
angular datasets. The test queries are further rows of the same draw.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["clustered", "make_data"]


def clustered(seed: int, n: int, dim: int, *, centers: int, noise: float,
              device: torch.device | str) -> torch.Tensor:
    """``(n, dim)`` float32 unit rows on ``device``: each a random one of
    ``centers`` standard-normal centres plus ``noise`` times a
    standard-normal vector, then normalised."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 64))
    c = torch.randn((centers, dim), generator=gen, device=device)
    pick = torch.randint(0, centers, (n,), generator=gen, device=device)
    x = torch.randn((n, dim), generator=gen, device=device)
    x.mul_(noise).add_(c[pick])
    return x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True))


def make_data(config: dict, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's train and test sets as host float32 arrays,
    what an ann-benchmarks client holds and hands to the index."""
    spec = config["data"]
    n, nq = config["train"], config["test"]
    x = clustered(seed, n + nq, config["dim"], centers=spec["centers"],
                  noise=spec["noise"], device=device)
    host = x.cpu().numpy()
    del x
    return host[:n], host[n:]
