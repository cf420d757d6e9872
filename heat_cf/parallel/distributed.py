"""Multi-host initialization and process-level data sharding.

The reference's multi-node story is mpirun + pickled dataset scatter
(main.py:22-97). The equivalent here:

* ``initialize()`` — jax.distributed.initialize for multi-host runs
  (give the coordinator address, process count and process id
  explicitly: a GPU host has no automatic cluster discovery);
* every host then loads the dataset locally and takes its deterministic
  user-range shard (data.shard_by_user_range with process_index) — no
  inter-host object exchange;
* ``global_mesh()`` — a ("data", "model") mesh over all global devices with
  hosts laid out along "data" so user rows stay host-local (the analog of
  the reference's rank-local user shards); item-shard traffic goes over
  the device interconnect (NVLink within a host).

Failure/elastic behavior (absent in the reference — an MPI rank failure
kills the job): restart the job and resume from the latest Orbax checkpoint
(heat_cf.checkpoint); initialize() is restart-safe.
"""

from __future__ import annotations

from typing import Optional

import jax

from heat_cf.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op if already initialized or
    single-process)."""
    if jax.process_count() > 1:
        return  # already initialized by the runtime
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        # Single-process run (no coordinator configured): proceed local.
        pass


def global_mesh(model_parallel: int = 1) -> "jax.sharding.Mesh":
    """Mesh over all global devices: hosts along "data", devices-within-host
    split between "data" and "model" (model_parallel divides local devices)."""
    n = len(jax.devices())
    if n % model_parallel != 0:
        raise ValueError(
            f"{n} devices not divisible by model_parallel={model_parallel}"
        )
    return make_mesh(n // model_parallel, model_parallel)


def process_shard_index() -> tuple[int, int]:
    """(num_shards, this_shard) for user-range dataset sharding."""
    return jax.process_count(), jax.process_index()
