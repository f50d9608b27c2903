"""The mesh and the multi-source ensemble; data parallelism and time-sharded
sequence parallelism over ``torch.distributed`` ranks (``launch`` starts
them)."""

from .dp import (  # noqa: F401
    phase2_epoch,
    phase3_epoch,
    phase4_epoch,
    phase5_epoch,
    phase5_grads,
    replicate,
    shard_epoch_batches,
)
from .dp_explicit import make_dp_phase1_epoch  # noqa: F401
from .mesh import data_sharding, domain_sharding, make_mesh, replicated  # noqa: F401
from .multi_source import MultiSourceEnsemble  # noqa: F401
from .sequence import (  # noqa: F401
    gather_time,
    shard_time,
    time_sharded_dilated_conv,
    time_sharded_os_cnn_res_apply,
    time_sharded_os_conv,
    time_sharded_waveglow_forward,
    time_sharded_wn_apply,
)
