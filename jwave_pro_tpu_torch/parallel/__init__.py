"""The sharded tier on ``torch.distributed`` (counterpart of
``jwave_pro_tpu/parallel``): device meshes, and transforms whose signal,
scale, packet or row axis is sharded over a mesh dim.  Import it
explicitly; ``jwave_pro_tpu_torch`` does not."""
from .mesh import (
    NamedSharding, P, init_distributed, make_mesh, shard_batch, shard_signal,
)
from .sharded import (
    cwt2_sharded, cwt_sharded, cwt_signal_sharded, dtcwt_sharded,
    fwt2_sharded, fwt_sharded, gather_fwt_layout, idtcwt_sharded,
    ifwt_sharded, imodwpt_sharded, imodwt_sharded, iwpt_sharded,
    imodwt2_sharded, modwpt_sharded, modwt2_sharded, modwt_sharded,
    scattering2d_sharded, scattering_sharded, ssq_sharded, wpt_sharded,
)

__all__ = [
    "NamedSharding", "P", "make_mesh", "shard_batch", "shard_signal",
    "cwt2_sharded", "cwt_sharded", "cwt_signal_sharded", "fwt2_sharded",
    "fwt_sharded", "gather_fwt_layout", "ifwt_sharded", "imodwt_sharded",
    "iwpt_sharded", "modwt_sharded", "scattering_sharded",
    "scattering2d_sharded", "ssq_sharded", "wpt_sharded",
    "modwt2_sharded", "imodwt2_sharded", "modwpt_sharded", "imodwpt_sharded",
    "dtcwt_sharded", "idtcwt_sharded", "init_distributed",
]
