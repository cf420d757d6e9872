"""Single-GPU benchmark of the huge-table code path.

BASELINE.json's config 5 (100M users x 10M items, d=128) needs a
multi-device mesh for the f32 footprint alone; tests validate that scale
abstractly (tests/test_large_scale.py) and the sharding on a virtual
mesh. This benchmark runs the SAME code path — tables above
``scatter.DENSE_ROWS_THRESHOLD`` rows take the sort-dedup row updates
instead of the dense-accumulator pass — on one card:

    16M users x 6M items, d=64, bf16 tables, 40M interactions,
    tile negative sampler + per-epoch cached history means,
    emb_pad=128 physical row width (see below).

The geometry was sized for a 16 GB device and leaves most of an 80 GB
H100 empty (ROADMAP 1.5 re-sizes it). Physical row width
(CFConfig.emb_pad): padding the tables to (N, 128) with zero tails
(identical math, tested) was the faster layout on the previous
accelerator; whether it is on the GPU is not measured yet. It costs real
bytes: bf16 is stored compactly at rest, 128 B/row at width 64 and 256 B
at width 128.

Device-memory budget at width 128: user 4.1 GB + pooled means 4.1 GB +
item 1.5 GB + flat history 0.64 GB + pairs 0.32 GB + packed batches
0.5 GB ~= 11.2 GB steady state. The f32 init intermediates must cast to
bf16 BEFORE the pad concat (models/state.py).

Refuses to run where JAX finds no GPU. Prints exactly one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from heat_cf.config import CFConfig
from heat_cf.data.datasets import ClickDataset
from heat_cf.train.engine import Engine
from heat_cf.train.scatter import DENSE_ROWS_THRESHOLD


def make_dataset(
    users: int, items: int, clicks: int, max_his: int, seed: int = 0
) -> ClickDataset:
    rng = np.random.default_rng(seed)
    pairs = np.stack(
        [rng.integers(0, users, clicks), rng.integers(0, items, clicks)],
        axis=1,
    ).astype(np.int32)
    return ClickDataset(
        pairs=pairs,
        his_items=rng.integers(0, items, (users, max_his)).astype(np.int32),
        masks=np.full((users,), max_his, np.int32),
        num_users=users,
        num_items=items,
        max_his=max_his,
        user_items=[],
    )


def make_config(
    dim: int = 64,
    negs: int = 16,
    max_his: int = 10,
    batch: int = 32_768,
    tile: int = 0,
    refresh: int = 32_768,
    update_mode: str = "dedup",
    emb_pad: int = 128,
    aggregator: str = "mean",
) -> CFConfig:
    """The huge-table treatment: bf16 tables and scoring, tile sampler,
    cached pooled means, emb_pad rows."""
    return CFConfig(
        emb_dim=dim,
        num_negs=negs,
        max_his=max_his,
        batch_size=batch,
        l_r=0.01,
        clip_val=1.0,
        milestones=[10],
        seed=2022,
        neg_sampler=1,
        tile_size=tile,
        refresh_interval=refresh,
        his_refresh="subepoch",
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
        update_mode=update_mode,
        emb_pad=emb_pad if emb_pad > dim else 0,
        aggregator=aggregator,
    )


def main() -> None:
    from heat_cf.utils.cache import enable_compilation_cache
    from heat_cf.utils.device import device_peaks, device_record, require_gpu

    p = argparse.ArgumentParser()
    p.add_argument("--users", type=int, default=16_000_000)
    p.add_argument("--items", type=int, default=6_000_000)
    p.add_argument("--clicks", type=int, default=40_000_000)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--negs", type=int, default=16)
    p.add_argument("--max-his", type=int, default=10)
    p.add_argument("--batch", type=int, default=32_768)
    # <= 0 auto-tunes (tile, refresh) per the paper-Alg.-1 analog; at batch
    # 32768 that derives tile 128 (the (B, T) score/count buffers shrink
    # with the tile).
    p.add_argument("--tile", type=int, default=0)
    p.add_argument("--refresh", type=int, default=32_768)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument(
        "--update-mode", type=str, default="dedup",
        choices=("dedup", "direct"),
        help="dedup = sort/segment-sum per-row combine (clip(combined)); "
        "direct = one per-occurrence scatter-add per table",
    )
    p.add_argument(
        "--aggregator", type=str, default="mean",
        choices=("mean", "user_attention"),
        help="history pooling (emb_pad composes with the attention "
        "variants; self_attention needs his_refresh=step — not this "
        "harness's cached-pools shape)",
    )
    p.add_argument(
        "--emb-pad", type=int, default=128,
        help="physical minor width of the tables (CFConfig.emb_pad), at "
        "the price of doubled at-rest table bytes; 0 disables",
    )
    args = p.parse_args()
    dev = require_gpu()
    peaks = device_peaks(dev.device_kind)
    enable_compilation_cache()  # repeat runs skip re-compiling

    dataset = make_dataset(
        args.users, args.items, args.clicks, args.max_his
    )
    cfg = make_config(
        dim=args.dim,
        negs=args.negs,
        max_his=args.max_his,
        batch=args.batch,
        tile=args.tile,
        refresh=args.refresh,
        update_mode=args.update_mode,
        emb_pad=args.emb_pad,
        aggregator=args.aggregator,
    )
    engine = Engine(cfg, dataset)
    sorted_path = args.update_mode == "dedup" and (
        args.users > DENSE_ROWS_THRESHOLD
        and args.items > DENSE_ROWS_THRESHOLD
    )

    loss0 = engine.train_one_epoch()  # compile + warmup
    times = []
    losses = [loss0]
    for _ in range(args.reps):
        t0 = time.perf_counter()
        losses.append(engine.train_one_epoch())
        times.append(time.perf_counter() - t0)
    epoch_s = float(np.median(times))

    # Roofline fields: modeled algorithmically-necessary device-memory
    # traffic (table rows gathered/updated + the per-epoch pooled-means
    # build; fused intermediates excluded) against the device's published
    # peak, and the per-row gather/scatter counts.
    tile = engine.cfg.tile_size
    d = args.dim
    elem = 2  # bf16
    nb = -(-args.clicks // args.batch)
    b = args.batch
    pools_bytes = args.users * args.max_his * d * elem + args.users * d * elem
    per_step_bytes = (
        3 * b * d * elem            # user + means + pos gathers
        + tile * d * elem           # tile row gather
        + 2 * 2 * b * d * elem      # user rows: fused writeback+update r+w
        + 2 * (b + tile) * d * elem  # item rows: r+w
        + b * 4 * 3 + b * args.negs * 4
    )
    hbm_gb = (pools_bytes + nb * per_step_bytes) / 1e9
    rows_scattered = nb * (b + b + tile)   # user scatter + item scatter
    rows_gathered = nb * (3 * b + tile) + args.users * args.max_his
    result = {
        "metric": "large_scale_epoch_time",
        "value": round(epoch_s, 3),
        "unit": "s",
        "vs_baseline": None,  # no reference number exists at this scale
        "interactions_per_sec": round(args.clicks / epoch_s),
        "users": args.users,
        "items": args.items,
        "clicks": args.clicks,
        "emb_dim": args.dim,
        "sorted_dedup_path": sorted_path,
        "update_mode": args.update_mode,
        "losses": [round(l, 4) for l in losses],
        "hbm_gb_modeled": round(hbm_gb, 2),
        "hbm_gbps": round(hbm_gb / epoch_s, 1),
        "hbm_peak_frac": round(
            hbm_gb * 1e9 / epoch_s / peaks["hbm_bytes_per_s"], 4
        ),
        "rows_scattered": rows_scattered,
        "rows_gathered": rows_gathered,
        "scatter_ns_per_row_budget": round(
            epoch_s * 1e9 / max(1, rows_scattered), 1
        ),
        "device": device_record(),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
