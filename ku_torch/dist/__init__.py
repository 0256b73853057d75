"""Distribution over ``torch.distributed``: device meshes, sharding and the
data-parallel CD epoch (port of ``ku.dist``)."""

from ku_torch.dist.mesh import (
    NamedSharding,
    cd_epoch_dp,
    data_parallel_sharding,
    initialize_multihost,
    local_slice,
    make_mesh,
    place,
    replicate,
    shard_batch,
    shard_decode_state,
    shard_gan_state,
    shard_stacked_batches,
)
