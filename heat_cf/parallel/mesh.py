"""Device mesh and sharding layout.

The reference distributes work with MPI: users are split into contiguous
rank-local shards (main.py:51-70), the item table is partitioned per
sub-epoch with per-row MPI_Bcast synchronization (engine.cpp:262-286) and
per-row MPI_Allreduce averaging (engine.cpp:364-375), and the aggregator
weights are Allreduce-averaged (engine.cpp:148-155).

This layout replaces all of that with GSPMD sharding over a 2-D
mesh with axes ("data", "model"):

* user table + history arrays: row-sharded over "data" — each data shard
  owns a contiguous user range, the analog of the MPI user shards, and user
  rows never need synchronization (they are disjoint per shard);
* item table: row-sharded over "model" — the analog of the item-column
  partitions, except lookups are resolved by XLA-inserted collectives per
  minibatch instead of per-row broadcasts, and there is no staleness: every
  update is a sharded scatter into the one true table;
* aggregator weights w0, lr, step: replicated; the gradient is combined by
  an XLA all-reduce in the backward pass (the engine.cpp:148-155 average,
  but exact rather than "train locally then average");
* batches: sharded over "data" so each data shard processes its users'
  samples.

Everything runs under one jit: XLA chooses all-gather / reduce-scatter /
all-to-all placements from these annotations (the scaling-book recipe:
pick a mesh, annotate, let the compiler insert collectives).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from heat_cf.models.state import TrainState

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_data: int = 1,
    n_model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("data", "model") mesh over the given (or all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data * n_model != len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} != {len(devices)} devices"
        )
    arr = np.asarray(devices).reshape(n_data, n_model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Largest power-of-two model axis up to 4, rest on data."""
    n_model = 1
    for cand in (4, 2):
        if n_devices % cand == 0:
            n_model = cand
            break
    return n_devices // n_model, n_model


def train_state_shardings(mesh: Mesh, state: TrainState) -> TrainState:
    """A TrainState-shaped pytree of NamedShardings."""

    def ns(*spec: Any) -> NamedSharding:
        return NamedSharding(mesh, P(*spec))

    return TrainState(
        user_emb=ns(DATA_AXIS, None),
        item_emb=ns(MODEL_AXIS, None),
        w0=ns(),
        user_gacc=ns(DATA_AXIS, None) if state.user_gacc is not None else None,
        item_gacc=ns(MODEL_AXIS, None) if state.item_gacc is not None else None,
        lr=ns(),
        step=ns(),
        attn_q=ns() if state.attn_q is not None else None,
        opt_slots=(
            None
            if state.opt_slots is None
            else {
                k: (
                    ns(DATA_AXIS, None)
                    if k.startswith("user")
                    else ns(MODEL_AXIS, None) if k.startswith("item") else ns()
                )
                for k in state.opt_slots
            }
        ),
    )


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Place a TrainState onto the mesh with the canonical layout."""
    shardings = train_state_shardings(mesh, state)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, s) if x is not None else None,
        state,
        shardings,
        is_leaf=lambda x: x is None,
    )


def shard_data_arrays(mesh: Mesh, his_items, his_masks):
    """History arrays row-sharded over the data axis (they follow users).

    ``his_items`` may be (U, H) or flat (U*H,) — Engine's small-``max_his``
    layout; both shard user-major over "data".
    """
    his_spec = P(DATA_AXIS) if his_items.ndim == 1 else P(DATA_AXIS, None)
    his_items = jax.device_put(his_items, NamedSharding(mesh, his_spec))
    his_masks = jax.device_put(his_masks, NamedSharding(mesh, P(DATA_AXIS)))
    return his_items, his_masks


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """(num_batches, batch) arrays: split the batch dim over "data"."""
    return NamedSharding(mesh, P(None, DATA_AXIS))
