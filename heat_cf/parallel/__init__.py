from heat_cf.parallel.mesh import (
    make_mesh,
    shard_data_arrays,
    shard_train_state,
    train_state_shardings,
)

__all__ = [
    "make_mesh",
    "shard_data_arrays",
    "shard_train_state",
    "train_state_shardings",
]
