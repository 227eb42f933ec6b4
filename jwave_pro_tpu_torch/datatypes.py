"""Dense/sparse 1D/2D/3D value stores (``jwave/datatypes/`` analogs), in
PyTorch.

Counterpart of ``jwave_pro_tpu/datatypes.py``; same names and lifecycle.
The reference's ``Line/Block/Space`` hierarchy — dense ``*Full`` array
stores vs sparse ``*Hash`` HashMap stores, both behind the ``Super``
alloc/erase lifecycle (``datatypes/Super.java:36-100``,
``lines/LineFull.java``, ``lines/LineHash.java:147-225``) — is a side tier
the transform hot path never touches:

  * dense (*Full*): a tensor with an offset, on the store's device (the
    card unless ``device="cpu"`` is asked for);
  * sparse (*Hash*): a host-side ``{index: value}`` mapping with O(1)
    get/set and no densification.  ``to_bcoo()`` exports a coalesced
    ``torch.sparse_coo_tensor`` built from the stored entries (the name of
    the JAX package's BCOO export is kept), ``to_array()`` a dense tensor.

Lifecycle parity: ``alloc()``/``erase()``/``is_allocated`` mirror
``Super.java``; access before ``alloc`` raises
:class:`~jwave_pro_tpu_torch.exceptions.NotAllocated`, out-of-range indices
raise :class:`~jwave_pro_tpu_torch.exceptions.NotValid`, and a hash-store
``get`` of an unset index raises
:class:`~jwave_pro_tpu_torch.exceptions.NotFound` exactly like
``LineHash.get`` (``LineHash.java:183-199``).

Stores are immutable values, as in the JAX package: ``alloc``/``erase``/
``set`` return a NEW store, and ``set`` never writes into the tensor of
the store it came from.
"""
from __future__ import annotations

import dataclasses
import typing

import torch

from .exceptions import NotAllocated, NotFound, NotValid
from .utils.device import as_input

__all__ = ["Line", "Block", "Space", "SuperLine"]

_CARD = "cuda"


@dataclasses.dataclass(frozen=True)
class _Store:
    """Offset + size store with the Super alloc/erase lifecycle.

    ``data`` is None (unallocated), a tensor on ``device`` (dense/*Full*),
    or a host dict {relative-index-tuple: float} (sparse/*Hash*).
    """

    sizes: tuple[int, ...]
    offset: tuple[int, ...]
    data: typing.Any = None
    sparse: bool = False
    dtype: torch.dtype = torch.float64
    device: typing.Any = _CARD

    # -- construction (LineFull/LineHash ctor surface) ----------------------
    @classmethod
    def create(cls, *sizes, offset=None, dtype=torch.float64, device=_CARD):
        """Dense (*Full*) store, allocated immediately for convenience."""
        off = tuple(offset) if offset else (0,) * len(sizes)
        return cls(tuple(sizes), off,
                   torch.zeros(sizes, dtype=dtype, device=device), False,
                   dtype, device)

    @classmethod
    def sparse_create(cls, *sizes, offset=None, dtype=torch.float64,
                      device=_CARD):
        """Sparse (*Hash*) store — O(1) get/set, nothing densified."""
        off = tuple(offset) if offset else (0,) * len(sizes)
        return cls(tuple(sizes), off, {}, True, dtype, device)

    @classmethod
    def unallocated(cls, *sizes, offset=None, sparse=False,
                    dtype=torch.float64, device=_CARD):
        """Pre-``alloc()`` store (Super lifecycle start state)."""
        off = tuple(offset) if offset else (0,) * len(sizes)
        return cls(tuple(sizes), off, None, sparse, dtype, device)

    # -- Super lifecycle (Super.java:36-100) --------------------------------
    @property
    def is_allocated(self) -> bool:
        return self.data is not None

    def alloc(self) -> "_Store":
        """Allocate backing storage (no-op if already allocated, like
        ``LineHash.alloc``, ``LineHash.java:159-168``)."""
        if self.is_allocated:
            return self
        data = {} if self.sparse else torch.zeros(
            self.sizes, dtype=self.dtype, device=self.device)
        return dataclasses.replace(self, data=data)

    def erase(self) -> "_Store":
        """Drop the backing storage (``LineHash.erase``)."""
        return dataclasses.replace(self, data=None)

    def copy(self) -> "_Store":
        """Deep copy incl. data if allocated (``Super.copy``)."""
        if isinstance(self.data, dict):
            data = dict(self.data)
        elif self.data is not None:
            data = self.data.clone()
        else:
            data = None
        return dataclasses.replace(self, data=data)

    # -- checked access -----------------------------------------------------
    def _check_memory(self):
        if not self.is_allocated:
            raise NotAllocated(
                "no memory allocated for this object "
                "[parity: Super.checkMemory, Super.java:54-60]")

    def _rel(self, idx):
        if len(idx) != len(self.sizes):
            raise NotValid(f"expected {len(self.sizes)} indices, got "
                           f"{len(idx)}")
        rel = tuple(int(i) - o for i, o in zip(idx, self.offset))
        for r, s in zip(rel, self.sizes):
            if not 0 <= r < s:
                raise NotValid(
                    f"index {idx} out of range for offset {self.offset} "
                    f"sizes {self.sizes} [parity: Line.checkIndex]")
        return rel

    def get(self, *idx):
        self._check_memory()
        rel = self._rel(idx)
        if isinstance(self.data, dict):
            if rel not in self.data:
                raise NotFound(
                    f"no value stored for requested index {idx} "
                    "[parity: LineHash.java:192-195]")
            return self.data[rel]
        return self.data[rel]

    def set(self, *idx_and_value) -> "_Store":
        *idx, value = idx_and_value
        self._check_memory()
        rel = self._rel(idx)
        if isinstance(self.data, dict):
            new = dict(self.data)
            new[rel] = value
            return dataclasses.replace(self, data=new)
        data = self.data.clone()
        data[rel] = value
        return dataclasses.replace(self, data=data)

    # -- export -------------------------------------------------------------
    @property
    def shape(self):
        return self.sizes

    @property
    def nnz(self) -> int:
        """Stored-entry count (sparse) or total size (dense)."""
        if isinstance(self.data, dict):
            return len(self.data)
        return self.data.numel() if self.is_allocated else 0

    def to_array(self) -> torch.Tensor:
        """Dense tensor on the store's device (unset sparse entries are 0)."""
        self._check_memory()
        if isinstance(self.data, dict):
            out = torch.zeros(self.sizes, dtype=self.dtype)
            for rel, v in self.data.items():
                out[rel] = v
            return out.to(self.device)
        return self.data

    def to_bcoo(self) -> torch.Tensor:
        """The store as a coalesced ``torch.sparse_coo_tensor`` on its
        device — a sparse store's built from the stored entries directly,
        never through a dense intermediate."""
        self._check_memory()
        if not isinstance(self.data, dict):
            return self.data.to_sparse().coalesce()
        items = sorted(self.data.items())
        indices = torch.tensor([k for k, _ in items], dtype=torch.int64
                               ).reshape(-1, len(self.sizes)).T
        values = torch.tensor([v for _, v in items], dtype=self.dtype)
        return torch.sparse_coo_tensor(indices, values, self.sizes,
                                       device=self.device,
                                       check_invariants=True).coalesce()


class Line(_Store):
    """1D store (datatypes/lines/Line.java; Full/Hash via create/sparse_create)."""


class Block(_Store):
    """2D store (datatypes/blocks/Block.java)."""


class Space(_Store):
    """3D store (datatypes/spaces/Space.java)."""


@dataclasses.dataclass(frozen=True)
class SuperLine:
    """Windowing container over a long signal (datatypes/SuperLine.java).

    Produces fixed-size windows with hop — the functional analog of the
    reference's windowed iteration."""

    data: typing.Any
    window: int
    hop: int

    def windows(self) -> torch.Tensor:
        """(..., num_windows, window) copy of the signal's windows; num 0
        (an empty axis) when the signal is shorter than a window."""
        x = as_input(self.data)
        n = x.shape[-1]
        num = max(0, (n - self.window) // self.hop + 1)
        idx = (torch.arange(num, device=x.device)[:, None] * self.hop
               + torch.arange(self.window, device=x.device)[None, :])
        return x[..., idx]
