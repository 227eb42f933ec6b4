"""``cwt(x, scales, wavelet).coefficients`` with the default method: the
(rows, scales, n) complex scalogram of a (rows, n) batch."""
from __future__ import annotations

import jwave_pro_tpu_torch as jt

from ..reference import compare
from ..reference import cwt as ref
from .pool import PoolEntry


class Entry(PoolEntry):
    CHECK = "cwt_err"

    def configure(self, config):
        if config["wavelet"] != "Morlet":
            raise ValueError(f"no reference for {config['wavelet']!r}")
        self.omega0 = config["omega0"]
        self.wavelet = jt.MorletWavelet.from_omega0(self.omega0)
        s = config["scales"]
        self.scales = ref.log_scales(s["low"], s["high"], s["count"])

    def run(self, x):
        return jt.cwt(x, self.scales, self.wavelet).coefficients

    def error(self, x, out):
        return compare.rel_err_rows(
            out, lambda i, j: ref.cwt(x[i:j], self.scales, self.omega0),
            x.shape[0], axis=0)
