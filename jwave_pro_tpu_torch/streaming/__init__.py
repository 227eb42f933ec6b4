"""Streaming transforms — implemented, where the reference only scaffolds.

Counterpart of ``jwave_pro_tpu/streaming/__init__.py``; same names and
semantics.  The reference ships interfaces and a buffer
(``transforms/streaming/*``) but ``StreamingTransformFactory.create()``
throws UnsupportedOperationException for every transform type
(``StreamingTransformFactory.java:83-113``) and
``EfficientMODWTTransform.processChunkedMODWT`` throws too
(``EfficientMODWTTransform.java:251-278``).  Here:

  * :class:`CircularBuffer` — a ring buffer over the last axis whose
    ``append`` returns a new buffer (``CircularBuffer.java`` analog).  Its
    ``head`` and ``count`` are Python ints: they follow from the chunk
    lengths alone, so an update never waits on the device.
  * :class:`StreamingMODWT` — incremental updates: the MODWT is causal
    (``W_j[t]`` reads ``x[t − k·2^(j-1)]``, k ≥ 0), so appending S samples
    only recomputes the last S output columns from ``halo + S`` context
    samples, through ``modwt(method='auto')`` — the fused CUDA forward on
    a card.  Listener callbacks fire per update
    (``AbstractStreamingTransform.java:26-270``).
  * :class:`StreamingFWT` / :class:`StreamingWPT` / :class:`StreamingCWT` /
    :class:`StreamingFFT` — sliding-window recompute on the ring buffer.
  * :class:`StreamingVariance` — rolling per-scale wavelet variance.
  * :func:`modwt_chunked` — bounded-memory chunked MODWT carrying the
    causal left context; sample-exact against the full-signal circular
    MODWT at every output index ≥ halo.
  * :func:`streaming_transform` — the factory that works.
  * :func:`save_state` / :func:`load_state` — the JAX package's ``.npz``
    keys, so a state saved by either package loads into the other.

``trace_counts`` counts, per step kind, the first call for each chunk
shape and set of static arguments — what the JAX package counts as jit
traces (a windowed transform's steps are counted per instance, as that
package compiles one step per instance).

A stream lives on ``StreamingConfig.device``, the card by default; each
chunk is moved there in the configured dtype.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import typing

import numpy as np
import torch

from ..ops.cwt import CWTResult
from ..ops.cwt import cwt as _cwt
from ..ops.fft import fft as _fft
from ..ops.fwt import fwt as _fwt
from ..ops.modwt import modwt as _modwt
from ..ops.wpt import wpt as _wpt
from ..utils.device import as_input
from ..utils.profiling import spanned
from ..utils.validation import next_power_of_two
from ..wavelets.base import DiscreteWavelet

__all__ = [
    "CircularBuffer", "UpdateStrategy", "StreamingConfig", "StreamingMODWT",
    "StreamingFWT", "StreamingWPT", "StreamingCWT", "StreamingFFT",
    "StreamingVariance",
    "modwt_chunked", "streaming_transform", "recommended_buffer_size",
    "save_state", "load_state", "trace_counts",
]


class CircularBuffer(typing.NamedTuple):
    """Ring buffer over the last axis (CircularBuffer.java analog)."""

    data: torch.Tensor  # (capacity,)
    head: int           # next write position
    count: int          # valid samples (≤ capacity)

    @classmethod
    def create(cls, capacity: int, dtype=torch.float32, device="cuda"):
        return cls(torch.zeros((capacity,), dtype=dtype,
                               device=torch.device(device)), 0, 0)

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @spanned("jwave.stream.append")
    def append(self, chunk) -> "CircularBuffer":
        """Append samples; returns the new buffer (this one is unchanged).
        Sample i goes to position (head + i) mod capacity."""
        chunk = torch.as_tensor(chunk, dtype=self.data.dtype,
                                device=self.data.device)
        s = chunk.shape[-1]
        cap = self.capacity
        if s >= cap:
            return CircularBuffer(chunk[..., -cap:].clone(), 0, cap)
        first = min(s, cap - self.head)
        data = self.data.clone()
        data[self.head:self.head + first] = chunk[:first]
        data[:s - first] = chunk[first:]
        return CircularBuffer(data, (self.head + s) % cap,
                              min(self.count + s, cap))

    def window(self, size: int) -> torch.Tensor:
        """Most recent ``size`` samples in time order."""
        return self.to_array()[self.capacity - size:] \
            if size < self.capacity else self.to_array()

    @spanned("jwave.stream.window")
    def to_array(self) -> torch.Tensor:
        """Full buffer, oldest → newest."""
        return torch.roll(self.data, -self.head)


class UpdateStrategy(enum.Enum):
    """StreamingTransformConfig.UpdateStrategy parity (``:21-36``)."""

    INCREMENTAL = "incremental"
    FULL_RECOMPUTE = "full_recompute"


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """StreamingTransformConfig analog, as a plain dataclass; ``device``
    holds the stream's buffer and coefficients."""

    buffer_size: int
    max_level: int = 4
    update_strategy: UpdateStrategy = UpdateStrategy.INCREMENTAL
    dtype: typing.Any = torch.float32
    device: typing.Any = "cuda"


def recommended_buffer_size(transform_type: str, target_latency_samples: int,
                            max_level: int = 4) -> int:
    """Heuristics analog of ``StreamingTransformFactory.
    getRecommendedBufferSize`` (``:188-220``): at least 4× the level halo /
    next pow2 for block transforms."""
    t = transform_type.lower()
    if t in ("fwt", "wpt", "fft", "dft"):
        return next_power_of_two(max(target_latency_samples, 1 << max_level))
    if t == "modwt":
        return max(target_latency_samples, 4 * (1 << max_level))
    return max(target_latency_samples, 256)


#: First calls of each streaming step kind per chunk shape and static
#: arguments (the JAX package's jit-trace count): tests pin it at 1.
trace_counts: collections.Counter = collections.Counter()
_SEEN: set = set()


def _count_first(seen: set, kind: str, key: tuple) -> None:
    if (kind,) + key not in seen:
        seen.add((kind,) + key)
        trace_counts[kind] += 1


def _sig(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


@spanned("jwave.stream.tail")
def _causal_tail(window, s, wavelet: DiscreteWavelet, level: int):
    """Coefficients for the last ``s`` positions of ``window``.

    Every emitted column t ∈ [halo, halo+s) looks back at most ``halo``
    samples — always inside the window — so the circular transform of the
    window agrees with the causal form on exactly those columns, and the
    tail rides ``modwt``'s auto dispatch (the fused forward kernel takes
    any width on a card).  Columns < halo differ (circular wrap vs zero
    pad) and are dropped by the slice.
    """
    ctx = window.shape[-1]
    return _modwt(window, wavelet, level, method="auto")[..., ctx - s:]


def _incremental_modwt_step(buffer: CircularBuffer, coeffs, samples, *,
                            wavelet: DiscreteWavelet, level: int, halo: int):
    """One append + tail-recompute step."""
    _count_first(_SEEN, "modwt_incremental", (
        wavelet, level, halo, _sig(buffer.data), _sig(coeffs),
        _sig(samples)))
    s = samples.shape[-1]
    buffer = buffer.append(samples)
    tail = _causal_tail(buffer.window(halo + s), s, wavelet, level)
    return buffer, _splice(coeffs, tail)


@spanned("jwave.stream.splice")
def _splice(coeffs, tail):
    """The coefficients shifted left by the tail's width, the tail
    after them."""
    s = tail.shape[-1]
    return torch.cat([coeffs[..., s:], tail.to(coeffs.dtype)], -1)


def _full_modwt_step(buffer: CircularBuffer, samples, *,
                     wavelet: DiscreteWavelet, level: int):
    _count_first(_SEEN, "modwt_full", (wavelet, level, _sig(buffer.data),
                                       _sig(samples)))
    buffer = buffer.append(samples)
    return buffer, _modwt(buffer.to_array(), wavelet, level, method="direct")


@dataclasses.dataclass
class _StreamingBase:
    """Host-side stateful wrapper around the update steps.

    Also carries the listener surface of the reference's
    ``AbstractStreamingTransform`` (``AbstractStreamingTransform.java:
    26-270``): registered callbacks fire after every ``update`` with the
    fresh coefficients.
    """

    wavelet: DiscreteWavelet | None
    config: StreamingConfig

    def __post_init__(self):
        self._listeners: list = []
        self.reset()

    def reset(self):
        self.buffer = CircularBuffer.create(self.config.buffer_size,
                                            self.config.dtype,
                                            self.config.device)

    def get_current_buffer(self):
        return self.buffer.to_array()

    @spanned("jwave.stream.chunk")
    def _samples(self, samples) -> torch.Tensor:
        return torch.as_tensor(samples, dtype=self.config.dtype,
                               device=torch.device(self.config.device))

    # -- listener surface (AbstractStreamingTransform parity) ---------------
    def add_listener(self, fn) -> None:
        """Register ``fn(coefficients)`` to fire after each update."""
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        self._listeners.remove(fn)

    def _notify(self, result):
        for fn in list(self._listeners):
            fn(result)


class StreamingMODWT(_StreamingBase):
    """Incremental MODWT over a sliding buffer.

    ``update(samples)`` returns the (level+1, buffer_size) coefficient matrix
    for the current buffer.  With INCREMENTAL strategy only the newest
    ``len(samples)`` columns are recomputed (causality of the MODWT); with
    FULL_RECOMPUTE (or a chunk longer than the buffer less the halo) the
    whole circular-on-buffer transform is recomputed (identical to
    ``ops.modwt.modwt(method='direct')`` on the window).
    """

    def __post_init__(self):
        super().__post_init__()
        m = self.wavelet.length
        self._halo = (m - 1) * ((1 << self.config.max_level) - 1)
        self._coeffs = torch.zeros(
            (self.config.max_level + 1, self.config.buffer_size),
            dtype=self.config.dtype, device=torch.device(self.config.device))

    def reset(self):
        super().reset()
        if hasattr(self, "_coeffs"):
            self._coeffs = torch.zeros_like(self._coeffs)

    def _update_coeffs(self, samples):
        samples = self._samples(samples)
        s = samples.shape[-1]
        if (self.config.update_strategy is UpdateStrategy.FULL_RECOMPUTE
                or s + self._halo > self.config.buffer_size):
            self.buffer, self._coeffs = _full_modwt_step(
                self.buffer, samples, wavelet=self.wavelet,
                level=self.config.max_level)
        else:
            self.buffer, self._coeffs = _incremental_modwt_step(
                self.buffer, self._coeffs, samples, wavelet=self.wavelet,
                level=self.config.max_level, halo=self._halo)
        return self._coeffs

    @spanned("jwave.stream.update")
    def update(self, samples):
        out = self._update_coeffs(samples)
        self._notify(out)
        return out


def _var_cum_step(var, count, coeffs, *, s):
    _count_first(_SEEN, "variance_cum", (s, _sig(var), _sig(coeffs)))
    t2 = coeffs[:-1, ..., -s:] ** 2
    tot = count + s
    return (count * var + torch.sum(t2, dim=-1)) / tot, tot


def _var_ewma_step(var, coeffs, *, s, lam):
    _count_first(_SEEN, "variance_ewma", (s, lam, _sig(var), _sig(coeffs)))
    t2 = coeffs[:-1, ..., -s:] ** 2
    w = lam ** torch.arange(s - 1, -1, -1, dtype=t2.dtype, device=t2.device)
    return (lam ** s) * var + (1.0 - lam) * torch.sum(t2 * w, dim=-1)


@dataclasses.dataclass
class StreamingVariance(StreamingMODWT):
    """Rolling per-scale wavelet variance — real-time volatility by horizon.

    Rides the incremental MODWT: each chunk's newly final coefficient
    columns (the newest ``s`` columns never change again) update a
    per-scale running mean of W_j², so every coefficient is counted
    exactly once.  ``halflife=None`` (default) gives the cumulative
    estimator (→ the biased Percival–Walden ν̂²_j); ``halflife`` in samples
    switches to the exponentially weighted one (weights (1−λ)λᵏ,
    λ = 2^(−1/halflife)).  Listeners fire with the ``(level,)`` variance
    vector after each update.  The first ``(M−1)(2^L−1)`` samples carry a
    zero-fill transient.
    """

    halflife: float | None = None

    def __post_init__(self):
        super().__post_init__()
        dev = torch.device(self.config.device)
        self._var = torch.zeros((self.config.max_level,),
                                dtype=self.config.dtype, device=dev)
        self._count = torch.zeros((), dtype=self.config.dtype, device=dev)

    def reset(self):
        super().reset()
        if hasattr(self, "_var"):
            self._var = torch.zeros_like(self._var)
            self._count = torch.zeros_like(self._count)

    @property
    def variance(self):
        """Current (level,) per-scale variance estimate."""
        return self._var

    @spanned("jwave.stream.update")
    def update(self, samples):
        samples = self._samples(samples)
        s = int(samples.shape[-1])
        if s + self._halo > self.config.buffer_size:
            # the full-recompute fallback would wrap-contaminate (and for
            # s > buffer_size truncate) the "newest s columns" this
            # estimator counts
            raise ValueError(
                f"chunk of {s} samples exceeds the incremental window "
                f"(buffer_size {self.config.buffer_size} − halo "
                f"{self._halo}); use smaller chunks or a larger buffer")
        coeffs = self._update_coeffs(samples)
        if self.halflife is None:
            self._var, self._count = _var_cum_step(self._var, self._count,
                                                   coeffs, s=s)
        else:
            lam = 0.5 ** (1.0 / float(self.halflife))
            self._var = _var_ewma_step(self._var, coeffs, s=s, lam=lam)
        self._notify(self._var)
        return self._var


class _WindowedStreaming(_StreamingBase):
    """FULL_RECOMPUTE sliding-window transforms (inherently non-causal)."""

    _kind = "windowed"

    def _transform(self, window):
        raise NotImplementedError

    def __post_init__(self):
        super().__post_init__()
        self._seen: set = set()

    def update(self, samples):
        samples = self._samples(samples)
        _count_first(self._seen, self._kind, (_sig(samples),
                                              _sig(self.buffer.data)))
        self.buffer = self.buffer.append(samples)
        out = self._transform(self.buffer.to_array())
        self._notify(out)
        return out


class StreamingFWT(_WindowedStreaming):
    _kind = "fwt"

    def _transform(self, window):
        return _fwt(window, self.wavelet, self.config.max_level)


class StreamingWPT(_WindowedStreaming):
    _kind = "wpt"

    def _transform(self, window):
        return _wpt(window, self.wavelet, self.config.max_level)


class StreamingFFT(_WindowedStreaming):
    _kind = "fft"

    def _transform(self, window):
        return _fft(window)


@dataclasses.dataclass
class StreamingCWT(_StreamingBase):
    scales: typing.Any = None
    sampling_rate: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        self._seen: set = set()

    def update(self, samples):
        """Returns the coefficient tensor (build a CWTResult via
        ``result()``)."""
        samples = self._samples(samples)
        _count_first(self._seen, "cwt", (_sig(samples),
                                         _sig(self.buffer.data)))
        self.buffer = self.buffer.append(samples)
        self._coeffs = _cwt(self.buffer.to_array(), np.asarray(self.scales),
                            self.wavelet, self.sampling_rate).coefficients
        self._notify(self._coeffs)
        return self._coeffs

    def result(self):
        """CWTResult view over the latest coefficients."""
        dev = self._coeffs.device
        dt = 1.0 / self.sampling_rate
        n = self.config.buffer_size
        return CWTResult(self._coeffs,
                         torch.as_tensor(np.asarray(self.scales), device=dev),
                         torch.as_tensor(np.arange(n) * dt, device=dev),
                         self.sampling_rate, self.wavelet.name)


def modwt_chunked(chunks, wavelet: DiscreteWavelet, level: int):
    """Bounded-memory chunked MODWT (EfficientMODWTTransform.
    processChunkedMODWT, implemented).

    ``chunks`` is an iterable of tensors or arrays (..., S), each on the
    device it lies on (a non-tensor goes to the card).  Yields
    ``(level+1, ..., S)`` coefficient blocks.  The causal left context of
    ``(M−1)(2^level −1)`` samples is carried between chunks, so
    concatenated outputs equal the full-signal MODWT at every index ≥ halo
    (earlier indices use zero context instead of the circular wrap, which
    streaming cannot know).
    """
    m = wavelet.length
    halo = (m - 1) * ((1 << level) - 1)
    ctx = None
    for chunk in chunks:
        chunk = as_input(chunk)
        s = chunk.shape[-1]
        if ctx is None:
            ctx = chunk.new_zeros(chunk.shape[:-1] + (halo,))
        window = torch.cat([ctx, chunk], dim=-1)
        yield _causal_tail(window, s, wavelet, level)
        ctx = window[..., -halo:]  # window is always ≥ halo samples long


_FACTORY = {
    "fwt": StreamingFWT,
    "wpt": StreamingWPT,
    "modwt": StreamingMODWT,
    "fft": StreamingFFT,
    "cwt": StreamingCWT,
    "variance": StreamingVariance,
}


def streaming_transform(transform_type: str, wavelet=None,
                        config: StreamingConfig | None = None, **kwargs):
    """Factory (parity surface of ``StreamingTransformFactory.create`` —
    which throws for every type; this one works)."""
    t = transform_type.lower()
    if t not in _FACTORY:
        raise ValueError(f"unknown streaming transform {transform_type!r}; "
                         f"known: {sorted(_FACTORY)}")
    config = config or StreamingConfig(buffer_size=recommended_buffer_size(
        t, 256, 4))
    return _FACTORY[t](wavelet, config, **kwargs)


# -- checkpoint/resume: the JAX package's .npz keys ---------------------------

def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_state(stream, path: str) -> None:
    """Persist a streaming transform's state (ring buffer + caches) to .npz
    (``head`` and ``count`` as int32 scalars, as the JAX package saves
    them)."""
    payload = {
        "data": _host(stream.buffer.data),
        "head": np.asarray(stream.buffer.head, dtype=np.int32),
        "count": np.asarray(stream.buffer.count, dtype=np.int32),
    }
    if hasattr(stream, "_coeffs"):
        payload["coeffs"] = _host(stream._coeffs)
    if hasattr(stream, "_var"):
        payload["var"] = _host(stream._var)
        payload["var_count"] = _host(stream._count)
    np.savez(path, **payload)


def load_state(stream, path: str) -> None:
    """Restore state saved by :func:`save_state` (of either package) into
    ``stream`` (in place), on the stream's device."""
    z = np.load(path if str(path).endswith(".npz") else path + ".npz")
    dev = torch.device(stream.config.device)

    def put(key):
        return torch.from_numpy(np.asarray(z[key])).to(dev)

    stream.buffer = CircularBuffer(put("data"), int(z["head"]),
                                   int(z["count"]))
    if "coeffs" in z and hasattr(stream, "_coeffs"):
        stream._coeffs = put("coeffs")
    if "var" in z and hasattr(stream, "_var"):
        stream._var = put("var")
        stream._count = put("var_count")
