"""Stateful block FIR filtering, overlap-save streaming
(``cubicsdr_tpu/ops/fir.py``).

The carried state is the last K-1 input samples, the history liquid's
firfilt object keeps, so streaming block by block equals
``scipy.signal.lfilter`` on the concatenated stream. Data is real float32,
planar ``PC`` or complex64; taps are real, or complex (held as a ``PC`` of
two buffers), and complex taps on real data give planar output.
"""

from __future__ import annotations

import numpy as np
import torch

from cubicsdr_tpu_torch.ops.planar import (
    PC, PLANAR, dtype_zeros, xcat, xslice, xtail)
from cubicsdr_tpu_torch.stream.op import StreamOp
from cubicsdr_tpu_torch.utils.convolve import conv1d


def fir_block(hist, x, taps):
    """One streaming FIR step. hist [..., K-1] previous inputs, x [..., L]
    (tensors or PCs); taps a real tensor [K] or a PC. Returns
    (new_hist, y [..., L]) with y[n] = sum_k taps[k] * stream[n - k]."""
    z = xcat([hist, x])
    y = conv1d(z, taps)
    return xtail(z, taps.shape[-1] - 1), y


class _Taps(StreamOp):
    """Holds numpy taps as buffers: ``taps`` (real) or ``taps_re`` and
    ``taps_im`` (complex)."""

    def __init__(self, taps, batch_shape: tuple, dtype):
        super().__init__()
        t = np.asarray(taps)
        self.complex_taps = bool(np.iscomplexobj(t))
        if self.complex_taps:
            self.register_buffer("taps_re", torch.from_numpy(
                t.real.astype(np.float32)))
            self.register_buffer("taps_im", torch.from_numpy(
                t.imag.astype(np.float32)))
        else:
            self.register_buffer("taps", torch.from_numpy(
                t.astype(np.float32)))
        self.n_taps = t.shape[0]
        self.batch_shape = tuple(batch_shape)
        self.dtype = dtype

    def tap_set(self):
        return PC(self.taps_re, self.taps_im) if self.complex_taps \
            else self.taps


class FirFilter(_Taps):
    """Streaming FIR on real (``dtype=torch.float32``), planar
    (``dtype=PLANAR``) or complex64 (``dtype=torch.complex64``) data with
    real or complex taps."""

    def __init__(self, taps, batch_shape: tuple = (), dtype=PLANAR):
        super().__init__(taps, batch_shape, dtype)

    def init_state(self):
        return dtype_zeros((*self.batch_shape, self.n_taps - 1), self.dtype,
                           self.device)

    def apply(self, hist, x):
        return fir_block(hist, x, self.tap_set())

    # Time-sharding: the carried state IS the input tail.
    shard_kind = "tail"

    def shard_halo_len(self) -> int:
        return self.n_taps - 1

    def shard_carry_init(self):
        return self.init_state()


class DelayLine(StreamOp):
    """Integer-sample delay y[t] = x[t-d] (zeros before the stream), used to
    phase-align parallel paths (FM-stereo's mono and subcarrier)."""

    def __init__(self, delay: int, batch_shape: tuple = (),
                 dtype=torch.float32):
        super().__init__()
        self.delay = int(delay)
        self.batch_shape = tuple(batch_shape)
        self.dtype = dtype

    def init_state(self):
        return dtype_zeros((*self.batch_shape, self.delay), self.dtype,
                           self.device)

    # Time-sharding: the carried state IS the input tail.
    shard_kind = "tail"

    def shard_halo_len(self) -> int:
        return self.delay

    def shard_carry_init(self):
        return self.init_state()

    def apply(self, hist, x):
        if self.delay == 0:
            return hist, x
        z = xcat([hist, x])
        L = x.shape[-1]
        return xslice(z, slice(L, None)), xslice(z, slice(0, L))


class FirDecimator(_Taps):
    """Streaming FIR + decimate by ``decim`` (ref: liquid's firdecim);
    each block's length must be a multiple of ``decim``. The history is
    padded to a multiple of ``decim`` so that output n sits at stream
    index n * decim, as one-shot ``lfilter(h, 1, x)[::decim]``."""

    def __init__(self, taps, decim: int, batch_shape: tuple = (),
                 dtype=PLANAR):
        super().__init__(taps, batch_shape, dtype)
        self.decim = int(decim)
        self.hist_len = -(-(self.n_taps - 1) // self.decim) * self.decim

    def init_state(self):
        return dtype_zeros((*self.batch_shape, self.hist_len), self.dtype,
                           self.device)

    def apply(self, hist, x):
        if x.shape[-1] % self.decim:
            raise ValueError(f"block length {x.shape[-1]} is not a "
                             f"multiple of decim={self.decim}")
        z = xcat([hist, x])
        # The first window ends at the first output position:
        # y[n] = sum_k h[k] z[hist_len + n*decim - k].
        start = self.hist_len - (self.n_taps - 1)
        y = conv1d(xslice(z, slice(start, None)), self.tap_set(),
                   stride=self.decim)
        return xtail(z, self.hist_len), y
