"""Enforce-style error helpers.

PyTorch port of ``paddle_tpu.framework.errors`` — the same typed-error
taxonomy as ``PADDLE_ENFORCE*`` / ``platform::errors`` (reference:
paddle/fluid/platform/enforce.h, paddle/fluid/platform/errors.h), as plain
Python exceptions.  Pure Python; the port carries its own copy so that it
never imports the JAX package.
"""
from __future__ import annotations

__all__ = [
    "EnforceNotMet",
    "InvalidArgumentError",
    "NotFoundError",
    "OutOfRangeError",
    "AlreadyExistsError",
    "PermissionDeniedError",
    "UnimplementedError",
    "UnavailableError",
    "PreconditionNotMetError",
    "ExecutionTimeoutError",
    "TransientDeviceError",
    "is_transient",
]


class EnforceNotMet(RuntimeError):
    """Base error, parity with paddle's EnforceNotMet."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet):
    pass


class PermissionDeniedError(EnforceNotMet):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    pass


class TransientDeviceError(UnavailableError):
    """A device/runtime failure that is expected to clear on retry.  The
    serving loops restart in-flight requests on these; anything else is
    fatal and propagates."""


#: lowercase substrings of runtime error messages that indicate a
#: transient condition worth retrying (status strings are the stable
#: surface of the CUDA runtime and of distributed transports alike)
_TRANSIENT_PATTERNS = (
    "resource_exhausted",
    "resource exhausted",
    "unavailable",
    "deadline_exceeded",
    "deadline exceeded",
    "aborted",
    "connection reset",
    "broken pipe",
    "socket closed",
    "transient",
)


def is_transient(exc: BaseException) -> bool:
    """True when ``exc`` should be retried: either already typed transient
    (:class:`TransientDeviceError` / :class:`UnavailableError`) or a raw
    runtime error whose message matches a known-transient pattern.  Typed
    framework errors other than Unavailable are *never* transient — an
    InvalidArgumentError does not fix itself."""
    if isinstance(exc, UnavailableError):
        return True
    if isinstance(exc, EnforceNotMet):
        return False  # typed taxonomy: everything else is deterministic
    if isinstance(exc, (RuntimeError, OSError)):
        msg = str(exc).lower()
        return any(p in msg for p in _TRANSIENT_PATTERNS)
    return False
