"""Deprecation plumbing for the ``repro_torch.api`` naming sweep.

The facade (:mod:`repro_torch.api`) owns the canonical verb set; the
legacy spellings (``configuration_from_mapping``,
``fuse_configuration``, ``all_device_configuration``) stay importable
as shims that delegate to the facade and emit one
:class:`DeprecationWarning` **per call
site** — a long-running serving loop hitting a shim every step warns
once, not once per request.
"""

from __future__ import annotations

import inspect
import warnings

# (old name, caller file, caller line) triples already warned about
_WARNED: set = set()


def warn_deprecated(old: str, new: str) -> None:
    """Warn that `old` is deprecated in favor of ``repro_torch.api``'s
    `new`, at most once per call site of the shim that invokes this
    (the shim's caller's file:line keys the dedup)."""
    site = ("<unknown>", 0)
    frame = inspect.currentframe()
    try:
        if frame is not None:
            shim = frame.f_back
            caller = shim.f_back if shim is not None else None
            if caller is not None:
                site = (caller.f_code.co_filename, caller.f_lineno)
    finally:
        del frame
    key = (old, site)
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(
        f"{old} is deprecated; use repro_torch.api.{new} (same arguments, "
        "same result)",
        DeprecationWarning,
        stacklevel=3,
    )


def reset_warned() -> None:
    """Forget warned-at sites (test isolation)."""
    _WARNED.clear()
