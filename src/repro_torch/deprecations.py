"""Deprecation machinery for the facade's renamed surface.

Every deprecated spelling (the paper-style camelCase aliases of
``MaRe``) funnels through :func:`warn_once`, which emits ONE
:class:`MaReDeprecationWarning` per spelling per process — interactive
sessions see the pointer to the new name exactly once instead of on
every call of a hot loop.  Tests of the shims call :func:`reset` between
cases.
"""
from __future__ import annotations

import threading
import warnings
from typing import Hashable, Set


class MaReDeprecationWarning(DeprecationWarning):
    """Category for every deprecated repro_torch.* spelling (filterable apart
    from third-party DeprecationWarnings)."""


_WARNED: Set[Hashable] = set()
_LOCK = threading.Lock()


def warn_once(key: Hashable, message: str, *, stacklevel: int = 3) -> bool:
    """Emit ``message`` as a :class:`MaReDeprecationWarning` the FIRST
    time ``key`` is seen (per process); return whether it warned."""
    with _LOCK:
        if key in _WARNED:
            return False
        _WARNED.add(key)
    warnings.warn(message, MaReDeprecationWarning, stacklevel=stacklevel)
    return True


def reset() -> None:
    """Forget which keys have warned (tests asserting warn-once)."""
    with _LOCK:
        _WARNED.clear()
