"""Multi-source ensemble on one card; the mesh and time-sharded sequence
parallelism over ``torch.distributed`` ranks (``launch`` starts them)."""

from .mesh import make_mesh  # noqa: F401
from .sequence import (  # noqa: F401
    gather_time,
    shard_time,
    time_sharded_dilated_conv,
    time_sharded_os_cnn_res_apply,
    time_sharded_os_conv,
    time_sharded_waveglow_forward,
    time_sharded_wn_apply,
)
