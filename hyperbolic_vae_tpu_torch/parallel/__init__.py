from hyperbolic_vae_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEED_AXIS,
    Mesh,
    data_sharding,
    init_distributed,
    make_mesh,
    make_seed_mesh,
    replicated,
    seed_sharding,
    shard_batch,
)
from hyperbolic_vae_tpu_torch.parallel.sharding_rules import (
    FSDP_MIN_LEAF_ELEMS,
    fsdp_param_shardings,
    fsdp_tp_param_shardings,
    opt_state_shardings,
    tp_param_shardings,
)
from hyperbolic_vae_tpu_torch.parallel.tensor_parallel import (
    ColumnParallelLinear,
    PlaneShardedHyperplanes,
    RowParallelLinear,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEED_AXIS",
    "Mesh",
    "data_sharding",
    "init_distributed",
    "make_mesh",
    "make_seed_mesh",
    "replicated",
    "seed_sharding",
    "shard_batch",
    "FSDP_MIN_LEAF_ELEMS",
    "tp_param_shardings",
    "fsdp_param_shardings",
    "fsdp_tp_param_shardings",
    "opt_state_shardings",
    "ColumnParallelLinear",
    "RowParallelLinear",
    "PlaneShardedHyperplanes",
]
