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
]
