"""``imodwt(modwt(x, wavelet, level), wavelet)``: the forward MODWT of a
(rows, n) batch and its inverse, both produced every call.  The check
holds the coefficients of every row to the reference's forward and the
reconstruction to the input, so a call that hands back its input without
transforming it fails."""
from __future__ import annotations

import jwave_pro_tpu_torch as jt

from ..reference import compare
from . import modwt


class Entry(modwt.Entry):

    def run(self, x):
        c = jt.modwt(x, self.wavelet, self.level)
        return c, jt.imodwt(c, self.wavelet)

    def error(self, x, out):
        c, back = out
        return max(super().error(x, c), compare.rel_err(back, x))
