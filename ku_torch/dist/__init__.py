"""Distribution over ``torch.distributed``: device meshes, sharding and the
data-parallel CD epoch (port of ``ku.dist``)."""

from ku_torch.dist.mesh import (
    cd_epoch_dp,
    initialize_multihost,
    make_mesh,
    shard_batch,
)
