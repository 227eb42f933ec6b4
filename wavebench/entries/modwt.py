"""``modwt(x, wavelet, level)``: the forward MODWT of a (rows, n) batch,
the whole (level + 1, rows, n) output produced every call."""
from __future__ import annotations

import jwave_pro_tpu_torch as jt

from ..reference import compare, filters
from ..reference import modwt as ref
from .pool import PoolEntry


class Entry(PoolEntry):
    CHECK = "modwt_err"

    def configure(self, config):
        self.wavelet = jt.wavelet(config["wavelet"])
        self.filters = filters.BY_NAME[config["wavelet"]]
        self.level = config["level"]

    def run(self, x):
        return jt.modwt(x, self.wavelet, self.level)

    def error(self, x, out):
        return compare.rel_err_rows(
            out, lambda i, j: ref.modwt(x[i:j], self.filters, self.level),
            x.shape[0], axis=1)
