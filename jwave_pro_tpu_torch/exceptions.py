"""Exception hierarchy (counterpart of ``jwave_pro_tpu/exceptions.py``).

The reference defines JWaveException ← JWaveFailure/JWaveError ←
NotAllocated/NotFound/NotImplemented/NotKnown/NotValid
(``exceptions/*.java:32-33``).  Here they are ordinary exceptions that the
library raises from validation paths, all ``ValueError`` subclasses so
generic callers can catch them idiomatically.
"""
from __future__ import annotations

__all__ = [
    "JWaveException", "JWaveFailure", "JWaveError", "NotAllocated",
    "NotFound", "NotImplemented_", "NotKnown", "NotValid",
]


class JWaveException(ValueError):
    """Base for all library errors (exceptions/JWaveException.java)."""


class JWaveFailure(JWaveException):
    """Recoverable failure (exceptions/JWaveFailure.java)."""


class JWaveError(JWaveException):
    """Serious error (exceptions/JWaveError.java)."""


class NotAllocated(JWaveError):
    pass


class NotFound(JWaveFailure):
    pass


class NotImplemented_(JWaveFailure):
    """NotImplemented is a Python builtin constant, hence the underscore."""


class NotKnown(JWaveFailure):
    """An unknown wavelet name."""


class NotValid(JWaveFailure):
    """An input the transform cannot take (e.g. a length that is not a
    power of two)."""
