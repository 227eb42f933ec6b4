"""Ahead-of-time export for production serving, in PyTorch.

Counterpart of ``jwave_pro_tpu/utils/deploy.py``: trace a pipeline ONCE
with ``torch.export``, serialize the graph to bytes, and reload it in a
serving process that runs the recorded graph without tracing library
code:

* every kernel of the package is a ``torch.library`` operator in the
  ``jwave`` namespace (``torch.ops.jwave.modwt_fwd`` and the others), so
  the graph records each launch as one node with its taps as constants,
  and the served graph launches the hand-written kernel; host planning
  that depends on the batch (grids, tile plans, ticket buffers) runs in
  the operator, at serving time;
* every float32 product of the decimated, Fourier and continuous tiers is
  the operator ``jwave::f32_mm``, so the graph keeps each product's
  precision tier (IEEE float32, or the banded CWT's TF32 where asked)
  whatever the serving process's TF32 setting;
* ``batch_polymorphic=True`` exports one artifact serving any batch size
  (a symbolic leading dimension).

Two differences from the JAX package: the serving process imports
``jwave_pro_tpu_torch`` (which registers the operators) where JAX's needs
only ``jax``; and an artifact runs on the device its example arguments
lay on — one artifact per device, where ``jax.export`` can lower one
artifact for several platforms.

Example::

    import jwave_pro_tpu_torch as jt
    w = jt.wavelet("Daubechies 4")
    art = jt.export_pipeline(
        lambda x: jt.modwt_denoise(x, w, 5, threshold=0.8),
        torch.zeros((8, 100003), device="cuda"), batch_polymorphic=True)
    open("denoise.pt2", "wb").write(art)
    # -- serving side --
    import jwave_pro_tpu_torch
    fn = jwave_pro_tpu_torch.load_pipeline(open("denoise.pt2", "rb").read())
    y = fn(batch)          # any batch size, same graph
"""
from __future__ import annotations

import io

import torch

__all__ = ["export_pipeline", "load_pipeline"]


class _Pipeline(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_pipeline(fn, *example_args, batch_polymorphic: bool = False,
                    platforms=None) -> bytes:
    """Export ``fn`` at the example arguments' shapes, dtypes and device →
    bytes (``torch.export.save``).

    ``fn`` must be a function of tensor arguments (close over wavelets,
    levels and thresholds: static configuration belongs at export time).
    ``batch_polymorphic=True`` makes every argument's LEADING axis one
    shared symbolic dimension ``b ≥ 1`` (0-d arguments keep their shape),
    so one artifact serves any batch size.  ``platforms``: ``None`` means
    the device type of the example arguments (``"cpu"`` or ``"cuda"``); a
    tuple that names any other raises ``ValueError`` (an artifact runs
    where it was traced).
    The example values themselves are not kept in the artifact.
    """
    args = tuple(a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
                 for a in example_args)
    devices = {a.device.type for a in args}
    if len(devices) > 1:
        raise ValueError(f"example arguments lie on several devices: "
                         f"{sorted(devices)}")
    if platforms is not None:
        if {str(p).lower() for p in platforms} != devices:
            raise ValueError(
                f"platforms {tuple(platforms)}: the artifact runs on the "
                f"example arguments' device ({', '.join(sorted(devices))}); "
                f"export once per device")
    dynamic = None
    if batch_polymorphic:
        b = torch.export.Dim("b", min=1)
        # one entry for forward's *args: a spec for each argument
        dynamic = (tuple({0: b} if a.ndim else None for a in args),)
    exported = torch.export.export(_Pipeline(fn), args,
                                   dynamic_shapes=dynamic)
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_pipeline(data: bytes):
    """Rebuild the callable from :func:`export_pipeline` bytes: it runs the
    exported graph, kernel operators included (the process must have
    imported ``jwave_pro_tpu_torch``)."""
    return torch.export.load(io.BytesIO(data)).module()
