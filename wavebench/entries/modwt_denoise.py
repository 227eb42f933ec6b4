"""``modwt_denoise(x, wavelet, level)`` with its defaults: the universal
threshold from the level-1 details, soft shrinkage, the inverse."""
from __future__ import annotations

import jwave_pro_tpu_torch as jt

from ..reference import compare
from ..reference import modwt as ref
from . import modwt


class Entry(modwt.Entry):
    CHECK = "denoise_err"

    def run(self, x):
        return jt.modwt_denoise(x, self.wavelet, self.level)

    def error(self, x, out):
        return compare.rel_err_rows(
            out, lambda i, j: ref.denoise(x[i:j], self.filters, self.level),
            x.shape[0], axis=0)
