"""Mesh-sweep FUNCTIONAL smoke: the same Engine workload on growing
("data" x "model") meshes over whatever devices exist.

This is NOT a performance measurement. Run on virtual CPU devices
(XLA_FLAGS=--xla_force_host_platform_device_count=8) throughput numbers
are meaningless; what this smoke checks is that the production sharding
layout trains at every mesh shape — losses finite and consistent with the
single-device engine. The sharded path on real GPUs is checked by
``python chip_smoke.py --four-cards``.

Prints one JSON line labeled {"functional_only": true}.
"""

from __future__ import annotations

import argparse
import json

import jax
import numpy as np

from heat_cf.config import CFConfig
from heat_cf.data.synthetic import synthetic_click_dataset
from heat_cf.parallel.mesh import default_mesh_shape, make_mesh
from heat_cf.train.engine import Engine


def sweep(counts=None, users=96, items=47, clicks_per_user=12):
    """Train one epoch per mesh size; returns {devices: loss}.

    Odd item count so every mesh shape exercises the divisibility-padding
    path. Raises on non-finite or wildly divergent losses.
    """
    n_avail = len(jax.devices())
    if counts is None:
        counts = [c for c in (1, 2, 4, 8) if c <= n_avail]
    train, test = synthetic_click_dataset(
        num_users=users, num_items=items,
        clicks_per_user=clicks_per_user, max_his=6, seed=3,
    )
    cfg_kwargs = dict(
        emb_dim=16, num_negs=4, max_his=6, batch_size=32,
        l_r=0.05, clip_val=0.5, seed=11,
    )
    losses = {}
    for c in counts:
        mesh = None
        if c > 1:
            n_data, n_model = default_mesh_shape(c)
            mesh = make_mesh(n_data, n_model, jax.devices()[:c])
        engine = Engine(CFConfig(**cfg_kwargs), train, test, mesh=mesh)
        loss = engine.train_one_epoch()
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss at {c} devices: {loss}")
        losses[c] = loss
    base = losses[counts[0]]
    for c, l in losses.items():
        if abs(l - base) / abs(base) > 5e-2:
            raise AssertionError(
                f"loss at {c} devices diverges from 1-device: {l} vs {base}"
            )
    return losses


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--users", type=int, default=96)
    parser.add_argument("--items", type=int, default=47)
    args = parser.parse_args()
    losses = sweep(users=args.users, items=args.items)
    print(
        json.dumps(
            {
                "metric": "scaling_functional_smoke",
                "functional_only": True,
                "losses": {str(c): round(l, 5) for c, l in losses.items()},
                "device": str(jax.devices()[0].platform),
                "note": (
                    "virtual-device mesh sweep; real multi-chip scaling "
                    "efficiency is hardware-blocked on this box "
                    "(BASELINE.md)"
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
