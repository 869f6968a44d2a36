"""Multi-device runtime of the port (the counterpart of ``repro.distributed``):
block-sharded SAGe residency, logical sharding rules on a ``DeviceMesh``,
the compressed data-parallel step and GPipe pipelining over
``torch.distributed``."""

from repro_torch.distributed.sharding import (
    BLOCK_AXIS,
    BlockMesh,
    Rules,
    block_shard_count,
    block_sharding,
    block_specs,
    current_rules,
    install_rules,
    make_block_mesh,
    param_shardings,
    shard_act,
    use_rules,
)
