"""Where a public entry point puts its input."""
from __future__ import annotations

import functools

import torch

__all__ = ["as_input", "as_signal", "tensor_cache", "tracing"]


def as_input(x) -> torch.Tensor:
    """A signal or coefficient argument as a tensor.

    A ``torch.Tensor`` stays on its own device: the caller chose it.
    Anything else (a NumPy array, a list, a number) becomes a tensor on
    ``torch.device("cuda")``, as the JAX package puts such an input on its
    default device.  There is no check for a card first: without one,
    torch's own error is raised, and nothing silently runs on the CPU.
    """
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=torch.device("cuda"))


def as_signal(x) -> torch.Tensor:
    """:func:`as_input`, with integer or boolean input promoted to torch's
    default float dtype.

    The JAX package's decimated transforms cast their filter constants to
    the input dtype, so an integer signal gives integer zeros there; the
    port transforms the values instead.
    """
    x = as_input(x)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.get_default_dtype())
    return x


def tracing() -> bool:
    """Whether torch is tracing the caller (``torch.export``,
    ``torch.compile``): its tensors are then fakes, which no cache may
    keep past the trace."""
    return torch.compiler.is_compiling()


def tensor_cache(maxsize: int | None):
    """``functools.lru_cache`` for a function that returns device tensors,
    bypassed while torch traces (:func:`tracing`): a tensor made during an
    export is a fake, and a cached fake would stand in for the constant in
    every later call."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            return fn(*args) if tracing() else cached(*args)

        call.cache_clear = cached.cache_clear
        return call

    return wrap
