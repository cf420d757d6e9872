"""Headline-scale accuracy parity: tile+fast vs uniform+exact.

Trains the AmazonBooks geometry (52,643 users x 91,599 items, d=64, 16
negatives) on synthetic planted clusters for 5 epochs in two modes and
prints both metric sets:

* fast: RandomTile negative sampler + per-epoch history-mean caching —
  the bench.py headline configuration;
* exact: uniform sampler + the reference's per-step history recompute.

The fast mode's approximations (tile working set, means staleness) must
not cost ranking accuracy — this is the claim behind the README results
table and the bench headline. Runs on whatever jax.devices() provides.

Usage: python scripts/accuracy_parity.py [--users U] [--items I] [--epochs N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from heat_cf.config import CFConfig  # noqa: E402
from heat_cf.data.synthetic import synthetic_click_dataset  # noqa: E402
from heat_cf.train.engine import Engine  # noqa: E402

METRICS = ["Recall(k=20)", "Recall(k=50)", "NDCG(k=20)", "NDCG(k=50)"]


def run(
    mode: str,
    train,
    test,
    epochs: int,
    dtype: str = "float32",
    param_dtype: str = "float32",
    seed: int = 2022,
    batch_size: int = 8192,
    l_r: float = 0.01,
    tile: int = 512,
    dim: int = 64,
    negs: int = 16,
    clip: float = 1.0,
    aggregator: str = "mean",
    his_refresh: str | None = None,
    loss: str = "PairwiseLogisticLoss",
    optimizer: str = "sgd",
    num_subepochs: int = 1,
    shuffle_mode: str | None = None,
    ccl_margin: float | None = None,
    ccl_neg_weight: float | None = None,
    visit_order: str | None = None,
) -> dict:
    refresh = max(8192, batch_size)  # tile refresh counts samples; keep
    # the per-batch cadence of the 8192 headline (refresh every step)
    if mode == "fast":
        kw = dict(
            neg_sampler=1, tile_size=tile, refresh_interval=refresh,
            his_refresh="subepoch",
        )
    elif mode == "direct":
        # fast + update_mode="direct" (per-occurrence scatter-add updates)
        kw = dict(
            neg_sampler=1, tile_size=tile, refresh_interval=refresh,
            his_refresh="subepoch", update_mode="direct",
        )
    elif mode == "default":
        # The reference's DEFAULT config combination (cf_config.py:7):
        # tile sampler + num_subepoches=2 — global-scope negatives (the
        # default after the DESIGN.md 6g collapse finding), per-sub-epoch
        # history refresh, direct updates. Exercises the round-4
        # on-device-bucketed fused sub-epoch epoch at full scale.
        kw = dict(
            neg_sampler=1, tile_size=tile, refresh_interval=refresh,
            his_refresh="subepoch", update_mode="direct",
            num_subepochs=2,
        )
    elif mode == "exact":
        kw = dict(neg_sampler=0, his_refresh="step")
    else:
        raise SystemExit(
            f"unknown mode {mode!r} (expected fast|direct|default|exact)"
        )
    # Round-5 axes: the ACCL attention
    # aggregators, the CCL loss, and the optimizer menu each get the
    # same full-scale treatment as the headline path — the DESIGN.md 6g
    # lesson (equivalence tests prove faithfulness, not quality; every
    # headline axis needs a full-scale accuracy run).
    kw["aggregator"] = aggregator
    kw["loss"] = loss
    kw["optimizer"] = optimizer
    if num_subepochs > 1:
        kw["num_subepochs"] = num_subepochs
    if aggregator == "self_attention":
        # Required mode (config.py): with cached pooling the learned
        # attention query receives no gradient.
        kw["his_refresh"] = "step"
    if his_refresh is not None:
        kw["his_refresh"] = his_refresh
    if ccl_margin is not None:
        kw["ccl_margin"] = ccl_margin
    if ccl_neg_weight is not None:
        kw["ccl_neg_weight"] = ccl_neg_weight
    if visit_order is not None:
        kw["visit_order"] = visit_order
    if shuffle_mode is not None:
        # "none" = the fork's live parse-order visit stream (the
        # synthetic pairs are user-grouped in parse order, like real
        # click files) — the shape behind the *_grouped_* bench rows
        # and the history-gather dedup.
        kw["shuffle_mode"] = shuffle_mode
    dropped_direct = False
    if optimizer != "sgd":
        # Moment-based optimizers must combine duplicate rows first.
        dropped_direct = kw.pop("update_mode", None) == "direct"
    cfg = CFConfig(
        emb_dim=dim, num_negs=negs, max_his=100, batch_size=batch_size,
        l_r=l_r, clip_val=clip, milestones=[10], seed=seed,
        metrics=METRICS, compute_dtype=dtype, param_dtype=param_dtype, **kw,
    )
    eng = Engine(cfg, train, test)
    losses = [round(eng.train_one_epoch(), 4) for _ in range(epochs)]
    m = eng.evaluate()
    out = {"losses": losses, **{k: round(v, 4) for k, v in m.items()}}
    if dropped_direct:
        # Keep the record honest: the requested mode label implies
        # update_mode="direct", but moment-based optimizers require the
        # dedup path — say so in the printed record itself.
        out["update_mode_effective"] = "dedup"
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=52_643)
    ap.add_argument("--items", type=int, default=91_599)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument(
        "--seed", type=int, default=2022,
        help="training seed (vary to estimate the training process's own "
        "metric variance before judging mode gaps)",
    )
    ap.add_argument(
        "--modes",
        type=str,
        default="fast,exact",
        help="comma list of mode[:compute_dtype[:param_dtype]] entries, "
        "e.g. 'fast,fast:bfloat16,fast:bfloat16:bfloat16,exact'",
    )
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument(
        "--lr", type=float, default=0.01,
        help="learning rate (the 16384-batch throughput mode uses 0.02 — "
        "linear batch scaling)",
    )
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--negs", type=int, default=16)
    ap.add_argument(
        "--clip", type=float, default=1.0,
        help="gradient clip (the Yelp18/Gowalla shapes use 0.1)",
    )
    ap.add_argument(
        "--tile", type=int, default=512,
        help="tile sampler size for fast/direct modes; <=0 auto-derives "
        "per the paper-Alg.-1 analog (128 at batch 32768)",
    )
    ap.add_argument(
        "--aggregator", type=str, default="mean",
        choices=("mean", "self_attention", "user_attention"),
        help="history pooling (the reference's named ACCL menu, "
        "behavior_aggregators.cpp:27); self_attention forces "
        "his_refresh='step' (its required mode)",
    )
    ap.add_argument(
        "--his-refresh", type=str, default=None,
        choices=("step", "subepoch"),
        help="override the mode's history-refresh cadence (e.g. "
        "user_attention under both cadences)",
    )
    ap.add_argument(
        "--loss", type=str, default="PairwiseLogisticLoss",
        choices=(
            "PairwiseLogisticLoss",
            "CosineContrastiveLoss",
            "SigmoidPairwiseLoss",
        ),
        help="training loss (CosineContrastiveLoss = the MF_CCL "
        "namesake, SimpleX margin 0.8 / weight 150)",
    )
    ap.add_argument(
        "--optimizer", type=str, default="sgd",
        choices=("sgd", "adagrad", "adam"),
        help="row-sparse optimizer (non-sgd drops update_mode=direct: "
        "moments require per-row dedup)",
    )
    ap.add_argument(
        "--subepochs", type=int, default=1,
        help="num_subepochs for non-'default' modes (composition runs)",
    )
    ap.add_argument(
        "--shuffle-mode", type=str, default=None,
        choices=("epoch", "once", "none"),
        help="positive-sample order ('none' = parse-order grouped "
        "stream, the *_grouped_* bench rows' shape)",
    )
    ap.add_argument(
        "--ccl-margin", type=float, default=None,
        help="CosineContrastiveLoss margin override (SimpleX default "
        "0.8; SimpleX tunes it per dataset)",
    )
    ap.add_argument(
        "--ccl-neg-weight", type=float, default=None,
        help="CosineContrastiveLoss negative-weight override (default 150)",
    )
    ap.add_argument(
        "--pair-order", type=str, default=None,
        choices=("user", "item"),
        help="stable-sort the train pairs by this column before training "
        "(mechanism probes: 'item' approximates the sub-epoch mode's "
        "item-partition-bucketed visit order; combine with "
        "--shuffle-mode none)",
    )
    ap.add_argument(
        "--visit-order", type=str, default=None,
        choices=("file", "user", "item"),
        help="cfg.visit_order — the SHIPPED knob for the same pre-sort "
        "(--pair-order sorts externally; this drives the engine's own "
        "sort, bitwise-equivalent per tests/test_engine.py)",
    )
    args = ap.parse_args()

    train, test = synthetic_click_dataset(
        num_users=args.users, num_items=args.items, max_his=100, seed=7
    )
    if args.pair_order is not None:
        import dataclasses

        import numpy as np

        col = 0 if args.pair_order == "user" else 1
        pairs = np.asarray(train.pairs)
        order = np.argsort(pairs[:, col], kind="stable")
        train = dataclasses.replace(train, pairs=pairs[order])
    out = {}
    for spec in args.modes.split(","):
        parts = spec.split(":")
        mode = parts[0]
        dtype = parts[1] if len(parts) > 1 else "float32"
        param_dtype = parts[2] if len(parts) > 2 else "float32"
        out[spec] = run(
            mode, train, test, args.epochs, dtype, param_dtype, args.seed,
            args.batch, args.lr, args.tile, args.dim, args.negs,
            args.clip, args.aggregator, args.his_refresh, args.loss,
            args.optimizer, args.subepochs, args.shuffle_mode,
            args.ccl_margin, args.ccl_neg_weight, args.visit_order,
        )
        print(json.dumps({spec: out[spec]}), flush=True)
    if "fast" not in out or "exact" not in out:
        return
    ratio = out["fast"]["Recall(k=20)"] / max(out["exact"]["Recall(k=20)"], 1e-9)
    print(json.dumps({"recall20_fast_over_exact": round(ratio, 4)}))


if __name__ == "__main__":
    main()
