"""Exceptions the slice raises (counterpart of ``jwave_pro_tpu/exceptions.py``).

The reference defines JWaveException ← JWaveFailure ← NotKnown
(``exceptions/*.java:32-33``); all are ``ValueError`` subclasses so generic
callers can catch them idiomatically.  The rest of the JAX package's
hierarchy arrives with the slices that raise it.
"""
from __future__ import annotations

__all__ = ["JWaveException", "JWaveFailure", "NotKnown"]


class JWaveException(ValueError):
    """Base for all library errors (exceptions/JWaveException.java)."""


class JWaveFailure(JWaveException):
    """Recoverable failure (exceptions/JWaveFailure.java)."""


class NotKnown(JWaveFailure):
    """An unknown wavelet name."""
