"""The best-basis search's share of the packet denoise's device time: the
device time of the operations enqueued inside the program's
``jwave.wpt.basis`` spans (the per-packet costs, the bottom-up program and
the top-down leaf masks) over that of every operation the traced calls
enqueued, kernels, copies and fills alike.  The body is
``threshold_device_share.denoise``'s, read from a private copy of that
module pointed at this span: operations matched to the host calls that
enqueued them by position on the one stream (``spans.matched``); None
where they do not match, or where the program opens no such span."""
from wavebench import core

BASIS = "jwave.wpt.basis"

_share = core.metric_reader("threshold_device_share.denoise")
_share.THRESHOLD = BASIS
read = _share.read
