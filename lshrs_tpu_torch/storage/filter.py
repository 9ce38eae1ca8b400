"""Query-time id filtering: the ``where=`` argument.

Id filters (allow / deny lists ranked exactly over the admitted subset)
are not ported yet (ROADMAP Queue A, filters). Every query entry point still
takes ``where=`` so call sites match the reference package; anything but
``None`` raises.
"""

from __future__ import annotations

__all__ = ["as_filter"]


def as_filter(where) -> None:
    """Coerce a ``where=`` argument: ``None`` means unfiltered."""
    if where is None:
        return None
    raise NotImplementedError(
        "where= id filters are not ported yet (ROADMAP Queue A, filters)"
    )
