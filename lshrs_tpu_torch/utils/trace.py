"""Named spans over the index's stages, for ``torch.profiler`` and NVTX.

``span(name)`` is a ``torch.profiler.record_function`` while a profiler
collects (``torch.profiler.profile``, or ``torch.autograd.profiler.
emit_nvtx`` under Nsight Systems) and a shared no-op otherwise: spans
exist exactly when someone traces, and cost one check of the profiler's
state when no one does. A span's events sit on the profiler's clock, the
one its device events use, so the device work a span launched and the
card's idle time inside it can be read from one trace. The span names
and what each covers are listed in ``README.md`` ("Tracing").
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

__all__ = ["span"]

_OFF = nullcontext()


def span(name: str):
    """A context manager that records ``name`` while a profiler is
    collecting, and does nothing otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
