"""Checkpoint / resume via Orbax.

The reference has no checkpointing at all (SURVEY.md section 5: weights live
in torch tensors aliased by C++ and are never saved; an MPI rank failure
kills the job). This module adds the capability idiomatically: the full
TrainState pytree (embedding shards, aggregator weights, grad accumulators,
lr, step), the sampler state, and the epoch counter are saved per epoch and
restorable onto any mesh layout (Orbax reshards on restore).

Orbax is an optional dependency: only ``--checkpoint-dir`` (and importing
this module) needs it.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

try:
    import orbax.checkpoint as ocp
except ImportError as exc:  # optional dependency
    raise ImportError(
        "checkpointing (--checkpoint-dir, heat_cf.checkpoint) needs the "
        "orbax-checkpoint package, which is not installed"
    ) from exc


class CheckpointManager:
    """Thin wrapper over ocp.CheckpointManager for Engine state."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self._mgr = ocp.CheckpointManager(
            self.directory,
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep, create=True
            ),
        )

    def save(self, engine) -> None:
        """Save engine state keyed by its epoch counter."""
        payload = {
            "state": engine.state,
            "sampler": engine.sampler_state,
            # Host numpy, not a device array: a single-device jax.Array is
            # "host-local" to Orbax and refuses to serialize in multi-host
            # runs (the key is identical on every host by construction).
            "key": np.asarray(jax.random.key_data(engine._key)),
            "epoch": np.asarray(engine.epoch, np.int64),
        }
        self._mgr.save(engine.epoch, args=ocp.args.StandardSave(payload))
        self._mgr.wait_until_finished()

    def restore_latest(self, engine) -> Optional[int]:
        """Restore the newest checkpoint into the engine; returns its epoch
        or None when the directory is empty."""
        step = self._mgr.latest_step()
        if step is None:
            return None

        def abstract(x):
            # Carry shardings so sharded/replicated arrays restore onto
            # their mesh layout instead of a single device.
            if isinstance(x, jax.Array):
                return jax.ShapeDtypeStruct(
                    x.shape, x.dtype, sharding=x.sharding
                )
            return x

        template = jax.tree.map(
            abstract,
            {
                "state": engine.state,
                "sampler": engine.sampler_state,
                "key": np.asarray(jax.random.key_data(engine._key)),
                "epoch": np.asarray(engine.epoch, np.int64),
            },
        )
        restored = self._mgr.restore(
            step, args=ocp.args.StandardRestore(template)
        )
        engine.state = restored["state"]
        engine.sampler_state = restored["sampler"]
        # Rebuild the key from host data: the restored array is committed to
        # one device, which would conflict with mesh-sharded step arguments.
        engine._key = jax.random.wrap_key_data(
            jnp.asarray(np.asarray(restored["key"]))
        )
        engine.epoch = int(restored["epoch"])
        return step

    def close(self) -> None:
        self._mgr.close()
