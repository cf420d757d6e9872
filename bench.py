"""Benchmark: AmazonBooks-scale epoch on one GPU.

Refuses to run where JAX finds no GPU, and records the device it ran on
(heat_cf.utils.device). The benchmark is to be redefined as named cells
with correctness checks (ROADMAP 1.1); its rows are unchanged here.

Reference baseline (BASELINE.md): HEAT trains one AmazonBooks MF_CCL epoch
(52,643 users x 91,599 items, d=64, 16 negatives, max_his=100, 2.38M
interactions) in ~245 s on an 8-thread CPU. This benchmark drives the real
Engine on the same workload shape (synthetic interactions; the hot path is
identical) and reports epoch time in two modes:

* headline: RandomTile negative sampler (BASELINE.json's AmazonBooks
  config uses the refresh_interval sampler — HEAT's own flagship
  optimization; here the tile keeps negative gathers/scatters in a T-row
  working set) + per-epoch history-mean caching (cfg.his_refresh=
  "subepoch") + bf16 tables/scoring + direct per-occurrence scatter-add
  updates (accuracy parity at full scale: scripts/accuracy_parity.py,
  plus tests/test_engine.py at small scale);
* exact: uniform sampler + the reference's per-step history recompute.

Prints exactly one JSON line.
"""

from __future__ import annotations

import json
import time

import numpy as np

from heat_cf.config import CFConfig
from heat_cf.data.datasets import ClickDataset
from heat_cf.train.engine import Engine

BASELINE_EPOCH_S = 245.0

# AmazonBooks MF_CCL geometry (README Step 6 / paper section 5.1; config at
# cf/benchmarks/AmazonBooks/MF_CCL/configs/config0.yaml).
NUM_USERS = 52_643
NUM_ITEMS = 91_599
TRAIN_SIZE = 2_380_730
EMB_DIM = 64
NUM_NEGS = 16
MAX_HIS = 100
BATCH = 8192


def make_dataset(rng: np.random.Generator) -> ClickDataset:
    pairs = np.stack(
        [
            rng.integers(0, NUM_USERS, TRAIN_SIZE),
            rng.integers(0, NUM_ITEMS, TRAIN_SIZE),
        ],
        axis=1,
    ).astype(np.int32)
    his = rng.integers(0, NUM_ITEMS, (NUM_USERS, MAX_HIS)).astype(np.int32)
    masks = np.full((NUM_USERS,), MAX_HIS, np.int32)
    return ClickDataset(
        pairs=pairs,
        his_items=his,
        masks=masks,
        num_users=NUM_USERS,
        num_items=NUM_ITEMS,
        max_his=MAX_HIS,
        user_items=[],
    )


def make_dataset_zipf(rng: np.random.Generator) -> ClickDataset:
    """Realistically-skewed variant: item
    popularity ~ Zipf(1.05) (hot items concentrate scatter collisions),
    user activity ~ Zipf(0.8), and geometric history lengths (mean ~20,
    many users short) instead of uniformly-full histories. Popular ids are
    permuted across the id space so skew is not accidentally aligned with
    table-shard or tile boundaries."""
    item_p = 1.0 / np.arange(1, NUM_ITEMS + 1, dtype=np.float64) ** 1.05
    item_p /= item_p.sum()
    item_perm = rng.permutation(NUM_ITEMS).astype(np.int32)
    user_p = 1.0 / np.arange(1, NUM_USERS + 1, dtype=np.float64) ** 0.8
    user_p /= user_p.sum()
    user_perm = rng.permutation(NUM_USERS).astype(np.int32)
    pairs = np.stack(
        [
            user_perm[rng.choice(NUM_USERS, TRAIN_SIZE, p=user_p)],
            item_perm[rng.choice(NUM_ITEMS, TRAIN_SIZE, p=item_p)],
        ],
        axis=1,
    ).astype(np.int32)
    his = item_perm[
        rng.choice(NUM_ITEMS, (NUM_USERS, MAX_HIS), p=item_p)
    ].astype(np.int32)
    masks = np.minimum(
        rng.geometric(1.0 / 20.0, NUM_USERS), MAX_HIS
    ).astype(np.int32)
    return ClickDataset(
        pairs=pairs,
        his_items=his,
        masks=masks,
        num_users=NUM_USERS,
        num_items=NUM_ITEMS,
        max_his=MAX_HIS,
        user_items=[],
    )


def modeled_epoch_bytes(mode: str, batch: int = BATCH) -> float:
    """Algorithmically-necessary device-memory traffic per epoch (lower
    bound): table rows gathered/updated + the once-per-epoch pooled-history
    build. Fused intermediates (score/count matrices) are excluded, so
    achieved/peak is a UTILIZATION LOWER BOUND for bandwidth-bound modes.
    Exact mode's GB/s is reported for contrast, with
    rows_gathered_per_epoch alongside."""
    nb = -(-TRAIN_SIZE // batch)
    d = EMB_DIM
    if mode == "headline":  # tile sampler, cached pools, bf16, direct
        elem = 2  # bf16 tables
        pools = NUM_USERS * MAX_HIS * d * elem + NUM_USERS * d * elem
        per_batch = (
            3 * batch * d * elem        # user + pos + means gathers
            + TILE * d * elem           # tile row gather
            + 2 * 2 * batch * d * elem  # user rows: read+write (scatter-add)
            + 2 * (batch + TILE) * d * elem  # item rows: read+write
            + batch * 4 * 3 + batch * NUM_NEGS * 4  # id/weight streams
        )
        return pools + nb * per_batch
    if mode == "exact":  # uniform sampler, per-step history regather, f32
        elem = 4
        per_batch = (
            batch * MAX_HIS * d * elem              # history gather
            + batch * d * elem * 2                  # user + pos gathers
            + batch * NUM_NEGS * d * elem           # negative gathers
            + 2 * batch * (1 + NUM_NEGS) * d * elem  # item dedup update r+w
            + 2 * batch * d * elem                  # user rows r+w
            + batch * 4 * 3 + batch * NUM_NEGS * 4
        )
        return nb * per_batch
    raise ValueError(mode)


def modeled_rows_gathered(mode: str, batch: int = BATCH) -> int:
    """Per-row gather count per epoch."""
    nb = -(-TRAIN_SIZE // batch)
    if mode == "headline":
        return nb * (3 * batch + TILE) + NUM_USERS * MAX_HIS
    if mode == "exact":
        return nb * batch * (2 + NUM_NEGS + MAX_HIS)
    raise ValueError(mode)


TILE = 512


def time_epochs(
    his_refresh: str,
    dataset: ClickDataset,
    reps: int = 3,
    fused: int = 0,
    **cfg_kw,
):
    """Median epoch seconds. fused=0 times per-epoch train_one_epoch calls
    (one dispatch per epoch, the reference's driver-loop granularity);
    fused=E times train_epochs(E)/E — E epochs in ONE device program."""
    base = dict(
        emb_dim=EMB_DIM,
        num_negs=NUM_NEGS,
        max_his=MAX_HIS,
        batch_size=BATCH,
        l_r=0.01,
        clip_val=1.0,
        milestones=[10],
        seed=2022,
        his_refresh=his_refresh,
    )
    base.update(cfg_kw)
    cfg = CFConfig(**base)
    engine = Engine(cfg, dataset)
    if fused:
        engine.train_epochs(fused)  # warmup/compile
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            engine.train_epochs(fused)
            times.append((time.perf_counter() - t0) / fused)
        del engine
        import gc

        gc.collect()
        return float(np.median(times)), times
    engine.train_one_epoch()  # warmup/compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.train_one_epoch()
        times.append(time.perf_counter() - t0)
    del engine
    import gc

    gc.collect()  # free donated tables before the next row compiles
    return float(np.median(times)), times


def time_full_run(dataset: ClickDataset, reps: int = 2, **cfg_kw):
    """The reference's ACTUAL deployment shape, end to end, as one
    wall-clock number: 5 epochs with a ranking
    evaluation after epochs 2 and 4 (cf/main.py:106-124 at the AmazonBooks
    config's epochs=5, eval_interval=2; the in-loop eval list is
    ['Recall(k=20)'], main.py:121). The reference's total for this shape
    is ~5 x 245 s for the epochs alone (evals extra — conservatively
    excluded from the baseline ratio).

    Measured both ways on the headline config:
      unfused — train_epochs segments + evaluate at each boundary
        (one dispatch per segment + per eval);
      fused — the whole run as ONE device program
        (Engine.run_epochs_with_eval / train/run.make_run_fn, or
        make_run_fn_subepoch when ``cfg_kw`` adds ``num_subepochs`` —
        the reference's DEFAULT shape, cf_config.py:7).
    Returns (unfused_s, fused_s) medians over ``reps``.
    """
    rng = np.random.default_rng(3)
    user_items = [rng.integers(0, NUM_ITEMS, 10) for _ in range(NUM_USERS)]
    test_ds = ClickDataset(
        pairs=np.zeros((0, 2), np.int32),
        his_items=dataset.his_items,
        masks=dataset.masks,
        num_users=NUM_USERS,
        num_items=NUM_ITEMS,
        max_his=MAX_HIS,
        user_items=user_items,
    )

    def make_engine():
        base = dict(
            emb_dim=EMB_DIM,
            num_negs=NUM_NEGS,
            max_his=MAX_HIS,
            batch_size=BATCH,
            l_r=0.01,
            clip_val=1.0,
            milestones=[10],
            seed=2022,
            his_refresh="subepoch",
            neg_sampler=1,
            tile_size=512,
            refresh_interval=8192,
            compute_dtype="bfloat16",
            param_dtype="bfloat16",
            update_mode="direct",
        )
        base.update(cfg_kw)
        return Engine(CFConfig(**base), dataset, test_ds)

    out = []
    for fused in (False, True):
        engine = make_engine()
        engine.run_epochs_with_eval(
            5, 2, metrics=["Recall(k=20)"], fused=fused
        )  # warmup/compile (programs are cached per engine)
        times = []
        for _ in range(reps):
            # Rewind the epoch counter so every rep runs the SAME
            # absolute schedule (run_epochs_with_eval anchors segments
            # and the lr schedule at engine.epoch) — identical segments
            # keep the cached fused program AND the train_epochs(seg)
            # chunk programs; without this each rep recompiles the run.
            engine.epoch = 0
            t0 = time.perf_counter()
            engine.run_epochs_with_eval(
                5, 2, metrics=["Recall(k=20)"], fused=fused
            )
            times.append(time.perf_counter() - t0)
        out.append(float(np.median(times)))
    return tuple(out)


def time_large_epoch(
    users: int = 6_000_000,
    items: int = 4_500_000,
    clicks: int = 10_000_000,
    dim: int = 64,
    negs: int = 16,
    max_his: int = 10,
    batch: int = 32_768,
    reps: int = 2,
):
    """Reduced huge-table geometry exercising the sort-dedup update path
    (both tables > scatter.DENSE_ROWS_THRESHOLD = 4M rows) with the
    bench_large.py treatment: bf16 tables, tile sampler (Alg-1 auto
    tile), cached pooled means, emb_pad=128 rows. Returns
    (median epoch s, geometry dict)."""
    import gc

    from heat_cf.train.scatter import DENSE_ROWS_THRESHOLD

    assert users > DENSE_ROWS_THRESHOLD and items > DENSE_ROWS_THRESHOLD
    rng = np.random.default_rng(13)
    dataset = ClickDataset(
        pairs=np.stack(
            [rng.integers(0, users, clicks), rng.integers(0, items, clicks)],
            axis=1,
        ).astype(np.int32),
        his_items=rng.integers(0, items, (users, max_his)).astype(np.int32),
        masks=np.full((users,), max_his, np.int32),
        num_users=users,
        num_items=items,
        max_his=max_his,
        user_items=[],
    )
    cfg = CFConfig(
        emb_dim=dim, num_negs=negs, max_his=max_his, batch_size=batch,
        l_r=0.01, clip_val=1.0, milestones=[10], seed=2022,
        neg_sampler=1, tile_size=0, refresh_interval=batch,
        his_refresh="subepoch", compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="dedup", emb_pad=128,
    )
    engine = Engine(cfg, dataset)
    engine.train_one_epoch()  # compile + warmup
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.train_one_epoch()
        times.append(time.perf_counter() - t0)
    del engine, dataset
    gc.collect()
    geom = {"users": users, "items": items, "clicks": clicks, "dim": dim}
    return float(np.median(times)), geom


def run_gpu_tier(marks: str | None = None):
    """Run the on-device hazard-regression tier (tests_gpu/) IN-PROCESS on
    the card this benchmark already holds (a second JAX process could not
    get the card's memory) and return (passed, failed, skipped) counts,
    so the record carries proof the tier ran. Tests marked
    ``deterministic`` skip unless the process started with
    ``--xla_gpu_deterministic_ops=true`` (chip_smoke.py runs them in a
    child process with it; this benchmark measures the default lowering).
    ``marks`` selects tests by a pytest -m expression.

    Setup/teardown errors and collection failures count as failures (a
    red tier must never read as green), and pytest's terminal output is
    routed to stderr so stdout keeps the one-JSON-line contract. The
    tier directory resolves relative to this file, not the cwd."""
    import contextlib
    import os
    import sys

    import pytest

    class _Counter:
        # Per-test outcome sets (a test whose call passes but whose
        # teardown errors must count as ONE failure, not one of each).
        def __init__(self):
            self._passed_ids = set()
            self._failed_ids = set()
            self.skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.skipped:
                self.skipped += 1
            elif report.failed:  # call failures AND setup/teardown errors
                self._failed_ids.add(report.nodeid)
                self._passed_ids.discard(report.nodeid)
            elif report.when == "call" and report.passed:
                if report.nodeid not in self._failed_ids:
                    self._passed_ids.add(report.nodeid)

        @property
        def passed(self):
            return len(self._passed_ids)

        @property
        def failed(self):
            return len(self._failed_ids)

    tier_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests_gpu")
    c = _Counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = pytest.main(
            [tier_dir, "-q", "-p", "no:cacheprovider", "--no-header",
             *(["-m", marks] if marks else [])],
            plugins=[c],
        )
    passed, failed = c.passed, c.failed
    if rc != 0 and failed == 0:
        # Collection/usage error with no per-test reports: still red
        # (pytest ExitCode is a small positive int).
        failed = int(rc)
    return passed, failed, c.skipped


def time_eval(dataset: ClickDataset, truth_ids=None):
    """Full AmazonBooks-scale ranking eval, end to end: tiled sim GEMM +
    exact top-50 + all-metric evaluation on device (mask and truth tensors
    are uploaded once; only the metric scalars reach the host).
    truth_ids: optional (U, 10) truth lists (e.g. Zipf-skewed) replacing
    the uniform default."""
    import jax

    from heat_cf.evaluation.evaluator import TiledEvaluator
    from heat_cf.evaluation.metrics import (
        evaluate_metrics_device,
        pad_truth,
    )

    k1, k2 = jax.random.split(jax.random.key(1))
    user_emb = jax.random.normal(k1, (NUM_USERS, EMB_DIM))
    item_emb = jax.random.normal(k2, (NUM_ITEMS, EMB_DIM))
    rng = np.random.default_rng(1)
    if truth_ids is None:
        truth_ids = [rng.integers(0, NUM_ITEMS, 10) for _ in range(NUM_USERS)]
    truth, lengths = pad_truth(truth_ids)
    truth, lengths = jax.numpy.asarray(truth), jax.numpy.asarray(lengths)
    metrics = ["Recall(k=20)", "Recall(k=50)", "NDCG(k=20)", "NDCG(k=50)"]
    ev = TiledEvaluator(dataset.pairs, NUM_USERS)

    def run():
        _, ids = ev.topk(user_emb, item_emb, 50, device=True)
        return jax.block_until_ready(
            evaluate_metrics_device(metrics, ids, truth, lengths)
        )

    run()  # compile + mask/truth upload
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def time_serving(dataset: ClickDataset) -> dict:
    """Serving latency at the AmazonBooks geometry — folds the
    profile_serving.py harness into the driver record (the request path
    is a shipped subsystem; a regression in the packed-bitmask request
    path or the pow2 batch bucketing should be visible between rounds).

    Times ``Recommender.recommend()`` end to end — user ids in, ranked
    top-20 ids on host out, INCLUDING the host->device id upload and the
    (B, k) download. Batch 1 is therefore dominated by the fixed
    dispatch/transfer cost; batch 8192 shows the marginal per-user cost.
    """
    import jax

    from heat_cf.models.state import init_train_state
    from heat_cf.serving import Recommender

    cfg = CFConfig(
        emb_dim=EMB_DIM, num_users=NUM_USERS, num_items=NUM_ITEMS,
        max_his=MAX_HIS, num_negs=NUM_NEGS, batch_size=BATCH, seed=0,
    )
    state = init_train_state(cfg, jax.random.key(0))
    rec = Recommender(
        state, cfg,
        seen_pairs=np.asarray(dataset.pairs),
        his_items=dataset.his_items,
        his_masks=dataset.masks,
    )
    rng = np.random.default_rng(3)
    out = {}
    for b, reps in ((1, 20), (256, 20), (8192, 5)):
        ids = rng.integers(0, NUM_USERS, b).tolist()
        res = rec.recommend(ids, k=20)  # compile + mask upload
        assert res.shape == (b, 20)
        t0 = time.perf_counter()
        for _ in range(reps):
            rec.recommend(ids, k=20)
        out[b] = (time.perf_counter() - t0) / reps
    return out


def main() -> None:
    global BATCH, EMB_DIM, NUM_NEGS, NUM_USERS, NUM_ITEMS, TRAIN_SIZE
    from heat_cf.utils.cache import enable_compilation_cache
    from heat_cf.utils.device import device_peaks, device_record, require_gpu

    dev = require_gpu()
    peaks = device_peaks(dev.device_kind)
    enable_compilation_cache()  # repeat runs skip re-compiling
    dataset = make_dataset(np.random.default_rng(0))
    # Headline mode: tile sampler + cached history means + bf16 tables AND
    # bf16 scoring + update_mode="direct" (per-occurrence scatter-add
    # increments, the reference live path's clip-per-sample ordering —
    # drops the f32 accumulator, touched mask, and dense table passes from
    # the update). Accuracy check at full scale:
    # scripts/accuracy_parity.py --modes direct:bfloat16:bfloat16,
    # fast:bfloat16:bfloat16 (the paper's own parity bar is +-0.0003
    # Recall@20, section 5.4).
    direct_s, direct_times = time_epochs(
        "subepoch", dataset, neg_sampler=1, tile_size=512,
        refresh_interval=8192, compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="direct",
    )
    # Headline config, 5 epochs per device program (Engine.train_epochs):
    # amortizes the fixed per-dispatch cost + the separately-dispatched
    # shuffle — how the CLI trains between evals with --fused-epochs.
    fused_s, _ = time_epochs(
        "subepoch", dataset, reps=2, fused=5, neg_sampler=1, tile_size=512,
        refresh_interval=8192, compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="direct",
    )
    # Sub-epoch mode at the REFERENCE'S DEFAULT combination (cf_config.py:7
    # pairs tile_size with num_subepoches): tile sampler + 2 sub-epochs,
    # one fused device program per epoch: shape-static padded bucket
    # packing (bucket sizes jitter per epoch; each fresh shape would
    # recompile) + the whole-tile fast path under partition-complement
    # constraints (tile remapped through the pool), with ON-DEVICE
    # bucketing (the program receives only the item permutation).
    subep_tile_s, _ = time_epochs(
        "subepoch", dataset, reps=3, neg_sampler=1, tile_size=512,
        refresh_interval=8192, num_subepochs=2, compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="direct",
    )
    # Same shape, 5 epochs per device program (train_epochs routes
    # sub-epoch configs through an epochs-scan over the bucketed epoch):
    # amortizes the per-epoch dispatch.
    subep_tile_f5_s, _ = time_epochs(
        "subepoch", dataset, reps=2, fused=5, neg_sampler=1,
        tile_size=512, refresh_interval=8192, num_subepochs=2,
        compute_dtype="bfloat16", param_dtype="bfloat16",
        update_mode="direct",
    )
    # Accumulator update mode (f32 grad accumulation + dense apply pass):
    # the previous headline, kept as the update-path A/B.
    fast_s, fast_times = time_epochs(
        "subepoch", dataset, neg_sampler=1, tile_size=512,
        refresh_interval=8192, compute_dtype="bfloat16",
        param_dtype="bfloat16",
    )
    fastf32_s, _ = time_epochs(
        "subepoch", dataset, reps=2, neg_sampler=1, tile_size=512,
        refresh_interval=8192,
    )
    # Throughput mode: batch 16384 with tile refresh retuned to the batch
    # (the paper's Alg. 1 retunes tile/refresh per hardware), reported
    # separately because the headline keeps the reference's exact
    # hyperparameters.
    BATCH = 16384
    fast16k_s, _ = time_epochs(
        "subepoch", dataset, reps=2, neg_sampler=1, tile_size=512,
        refresh_interval=16384, compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="direct",
    )
    # Large-batch frontier, with the paper-Alg.-1 auto-derived tile
    # (tile_size=0 -> 128 at these batches; the (B, T) score/count
    # buffers shrink 4x): Alg-1 retunes tile with batch, as the paper
    # retunes per hardware.
    BATCH = 32768
    fast32k_s, _ = time_epochs(
        "subepoch", dataset, reps=2, neg_sampler=1, tile_size=0,
        refresh_interval=32768, compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="direct",
    )
    # Large-batch row: 32k batch, auto tile, 5 epochs/dispatch.
    fast32kf_s, _ = time_epochs(
        "subepoch", dataset, reps=2, fused=5, neg_sampler=1, tile_size=0,
        refresh_interval=32768, compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="direct",
    )
    BATCH = 65536
    fast65k_s, _ = time_epochs(
        "subepoch", dataset, reps=2, neg_sampler=1, tile_size=0,
        refresh_interval=65536, compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="direct",
    )
    BATCH = 8192
    # Compute-heavy variant (BASELINE.json config 4): d=256, 64 negatives —
    # scoring-bound rather than update-bound. Same dataset geometry; the
    # d=256 tables re-initialize inside the engine.
    EMB_DIM, NUM_NEGS = 256, 64
    heavy_s, _ = time_epochs(
        "subepoch", dataset, reps=2, neg_sampler=1, tile_size=0,
        compute_dtype="bfloat16", param_dtype="bfloat16",
    )
    EMB_DIM, NUM_NEGS = 64, 16
    # ACCL aggregation rows: the reference NAMES the
    # menu — "average pooling, self-attention, and user-attention"
    # (behavior_aggregators.cpp:27) — and the paper's H-ACCL speedups are
    # a first-class baseline axis (BASELINE.md; ARM rows put ACCL within
    # ~1.2x of CCL). user-attention composes with the cached-pools
    # cadence (headline treatment; the attention weights go stale within
    # the refresh period — the mode's documented contract);
    # self-attention REQUIRES his_refresh="step" (config.py: live pooling
    # is the learned query's only gradient path), so its row carries the
    # per-step pooling cost. Full-scale accuracy runs:
    # scripts/accuracy_parity.py --aggregator ... (README ACCL section).
    accl_user_s, _ = time_epochs(
        "subepoch", dataset, reps=2, neg_sampler=1, tile_size=512,
        refresh_interval=8192, compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="direct",
        aggregator="user_attention",
    )
    accl_self_s, _ = time_epochs(
        "step", dataset, reps=2, neg_sampler=1, tile_size=512,
        refresh_interval=8192, compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="direct",
        aggregator="self_attention",
    )
    # The history-gather dedup extends to the attention aggregators
    # (train_step uniq_first path — pooling once per DISTINCT user inside
    # the loss; exact, single-step bitwise vs the undeduped step), on the
    # fork's live parse-order visit stream (user-grouped clicks).
    order0 = np.argsort(np.asarray(dataset.pairs)[:, 0], kind="stable")
    grouped0 = ClickDataset(
        pairs=np.asarray(dataset.pairs)[order0],
        his_items=dataset.his_items,
        masks=dataset.masks,
        num_users=NUM_USERS,
        num_items=NUM_ITEMS,
        max_his=MAX_HIS,
        user_items=[],
    )
    accl_self_grouped_s, _ = time_epochs(
        "step", grouped0, reps=2, fused=3, shuffle_mode="none",
        neg_sampler=1, tile_size=512, refresh_interval=8192,
        compute_dtype="bfloat16", param_dtype="bfloat16",
        update_mode="direct", aggregator="self_attention",
    )
    del grouped0
    # CosineContrastiveLoss — the MF_CCL family namesake (SimpleX margin
    # 0.8 / weight 150, cf/benchmarks/*/MF_CCL/) —
    # under the headline treatment. Full-scale accuracy run:
    # scripts/accuracy_parity.py --loss CosineContrastiveLoss.
    ccl_s, _ = time_epochs(
        "subepoch", dataset, reps=2, neg_sampler=1, tile_size=512,
        refresh_interval=8192, compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="direct",
        loss="CosineContrastiveLoss",
    )
    exact_s, _ = time_epochs("step", dataset)
    # Exact semantics with direct per-occurrence updates, which drop the
    # dense accumulator passes (clip-per-occurrence is the reference live
    # path's own ordering, sgd.cpp:14-26).
    exact_direct_s, _ = time_epochs(
        "step", dataset, reps=2, update_mode="direct"
    )
    # Exact semantics on the fork's LIVE visit order: real click files are
    # user-grouped, and the live MPI hot loop walks them in parse order
    # (engine.cpp:243-252, shuffle_mode="none"). Fixed streams enable the
    # history-gather dedup (train_step uniq_users path): H rows gathered
    # once per DISTINCT batch user — an exact rewrite (all reads in a
    # batched step see batch-start tables), cutting the dominant B*H
    # row-gather traffic by ~clicks-per-user (~45x here).
    order = np.argsort(np.asarray(dataset.pairs)[:, 0], kind="stable")
    grouped = ClickDataset(
        pairs=np.asarray(dataset.pairs)[order],
        his_items=dataset.his_items,
        masks=dataset.masks,
        num_users=NUM_USERS,
        num_items=NUM_ITEMS,
        max_his=MAX_HIS,
        user_items=[],
    )
    exact_grouped_s, _ = time_epochs(
        "step", grouped, reps=2, fused=3, shuffle_mode="none"
    )
    # Zipf-skewed headline: hot-item scatter
    # collisions + short histories, same config as the headline.
    zipf_ds = make_dataset_zipf(np.random.default_rng(7))
    zipf_s, _ = time_epochs(
        "subepoch", zipf_ds, reps=2,
        neg_sampler=1, tile_size=512, refresh_interval=8192,
        compute_dtype="bfloat16", param_dtype="bfloat16",
        update_mode="direct",
    )
    # Exact mode under skew: the history-gather dedup
    # win DEPENDS on duplication structure — user-grouped parse order on
    # the Zipf dataset (hot users contribute long runs; short geometric
    # histories shrink the per-user gather) must keep its speedup.
    zorder = np.argsort(np.asarray(zipf_ds.pairs)[:, 0], kind="stable")
    zipf_grouped = ClickDataset(
        pairs=np.asarray(zipf_ds.pairs)[zorder],
        his_items=zipf_ds.his_items,
        masks=zipf_ds.masks,
        num_users=NUM_USERS,
        num_items=NUM_ITEMS,
        max_his=MAX_HIS,
        user_items=[],
    )
    zipf_exact_s, _ = time_epochs(
        "step", zipf_grouped, reps=2, fused=3, shuffle_mode="none"
    )
    # Yelp18 dataset shape: the third reference
    # benchmark geometry — 31.7k x 38k, d=128, 64 negs, clip 0.1
    # (benchmarks/Yelp18/config0.yaml; paper section 5.1: 1.56M clicks).
    # Headline treatment (tile 512/refresh 8192 from the config, cached
    # pools, bf16, direct updates).
    (NUM_USERS, NUM_ITEMS, TRAIN_SIZE, EMB_DIM, NUM_NEGS) = (
        31_668, 38_048, 1_561_406, 128, 64,
    )
    yelp_ds = make_dataset(np.random.default_rng(5))
    yelp_s, _ = time_epochs(
        "subepoch", yelp_ds, reps=2, neg_sampler=1, tile_size=512,
        refresh_interval=8192, clip_val=0.1, compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="direct",
    )
    del yelp_ds
    # Gowalla dataset shape: 29.9k x 41k, d=128, 64 negs,
    # clip 0.1 (benchmarks/Gowalla/config0.yaml; paper section 5.1:
    # 1.03M clicks). Headline treatment.
    (NUM_USERS, NUM_ITEMS, TRAIN_SIZE, EMB_DIM, NUM_NEGS) = (
        29_858, 40_981, 1_027_370, 128, 64,
    )
    gowalla_ds = make_dataset(np.random.default_rng(6))
    gowalla_s, _ = time_epochs(
        "subepoch", gowalla_ds, reps=2, neg_sampler=1, tile_size=512,
        refresh_interval=8192, clip_val=0.1, compute_dtype="bfloat16",
        param_dtype="bfloat16", update_mode="direct",
    )
    del gowalla_ds
    (NUM_USERS, NUM_ITEMS, TRAIN_SIZE, EMB_DIM, NUM_NEGS) = (
        52_643, 91_599, 2_380_730, 64, 16,
    )
    # The reference's actual run shape, one wall-clock number + fused.
    full_run_s, full_run_fused_s = time_full_run(dataset)
    # Same schedule at the reference's DEFAULT config shape
    # (cf_config.py:7: tile sampler + num_subepoches=2): fused = the
    # whole schedule as ONE device program over the on-device-bucketed
    # sub-epoch epoch (train/run.make_run_fn_subepoch).
    full_run_def_s, full_run_def_fused_s = time_full_run(
        dataset, num_subepochs=2
    )
    eval_s = time_eval(dataset)
    # Eval under skew: Zipf-skewed train-pair mask (hot items concentrate
    # mask bits) and Zipf-skewed truth lists, same exact top-50 path.
    zrng = np.random.default_rng(11)
    item_p = 1.0 / np.arange(1, NUM_ITEMS + 1, dtype=np.float64) ** 1.05
    item_p /= item_p.sum()
    zipf_truth = [
        zrng.choice(NUM_ITEMS, 10, p=item_p) for _ in range(NUM_USERS)
    ]
    eval_skew_s = time_eval(zipf_ds, truth_ids=zipf_truth)
    del zipf_ds, zipf_truth
    # Serving request path (folds profile_serving.py into the record).
    serve = time_serving(dataset)
    # Huge-table row (the sort-dedup scatter path): tables above
    # scatter.DENSE_ROWS_THRESHOLD rows take _apply_row_updates_sorted
    # instead of the dense-accumulator pass, with emb_pad=128 rows
    # (DESIGN.md 2c-bis). Reduced geometry vs bench_large.py's 16M x 6M
    # x 40M-click harness: 6M users x 4.5M items x 10M clicks — SAME code
    # path (both tables over the 4M-row threshold), ~1/4 the clicks. Runs
    # last among the training rows so its tables see a clean device
    # memory. bench_large.py remains the full-scale harness.
    large_epoch_s, large_geom = time_large_epoch()
    head_gb = modeled_epoch_bytes("headline") / 1e9
    exact_gb = modeled_epoch_bytes("exact") / 1e9
    result = {
        "metric": "amazonbooks_epoch_time",
        "value": round(direct_s, 4),
        "unit": "s",
        "vs_baseline": round(BASELINE_EPOCH_S / direct_s, 2),
        "interactions_per_sec": round(TRAIN_SIZE / direct_s),
        "fused5_s": round(fused_s, 4),
        "fused5_vs_baseline": round(BASELINE_EPOCH_S / fused_s, 2),
        "accum_s": round(fast_s, 4),
        "accum_vs_baseline": round(BASELINE_EPOCH_S / fast_s, 2),
        "fast_f32_s": round(fastf32_s, 4),
        "exact_mode_s": round(exact_s, 4),
        "exact_vs_baseline": round(BASELINE_EPOCH_S / exact_s, 2),
        "exact_direct_s": round(exact_direct_s, 4),
        "exact_direct_vs_baseline": round(
            BASELINE_EPOCH_S / exact_direct_s, 2
        ),
        "exact_grouped_s": round(exact_grouped_s, 4),
        "exact_grouped_vs_baseline": round(
            BASELINE_EPOCH_S / exact_grouped_s, 2
        ),
        "throughput16k_s": round(fast16k_s, 4),
        "throughput16k_vs_baseline": round(BASELINE_EPOCH_S / fast16k_s, 2),
        "throughput32k_s": round(fast32k_s, 4),
        "throughput32k_vs_baseline": round(BASELINE_EPOCH_S / fast32k_s, 2),
        "throughput32k_fused5_s": round(fast32kf_s, 4),
        "throughput32k_fused5_vs_baseline": round(
            BASELINE_EPOCH_S / fast32kf_s, 2
        ),
        "throughput32k_fused5_interactions_per_sec": round(
            TRAIN_SIZE / fast32kf_s
        ),
        "throughput65k_s": round(fast65k_s, 4),
        "throughput65k_vs_baseline": round(BASELINE_EPOCH_S / fast65k_s, 2),
        "heavy_d256_negs64_s": round(heavy_s, 4),
        # ACCL rows: ratio context uses the CCL 245 s epoch (the
        # reference publishes no ACCL epoch seconds; paper ARM rows put
        # ACCL within ~1.2x of CCL).
        "accl_user_s": round(accl_user_s, 4),
        "accl_user_vs_ccl_baseline": round(
            BASELINE_EPOCH_S / accl_user_s, 2
        ),
        "accl_self_s": round(accl_self_s, 4),
        "accl_self_vs_ccl_baseline": round(
            BASELINE_EPOCH_S / accl_self_s, 2
        ),
        "accl_self_grouped_s": round(accl_self_grouped_s, 4),
        "accl_self_grouped_vs_ccl_baseline": round(
            BASELINE_EPOCH_S / accl_self_grouped_s, 2
        ),
        "ccl_s": round(ccl_s, 4),
        "ccl_vs_baseline": round(BASELINE_EPOCH_S / ccl_s, 2),
        "subepoch2_tile_fused5_s": round(subep_tile_f5_s, 4),
        "subepoch2_tile_fused5_vs_baseline": round(
            BASELINE_EPOCH_S / subep_tile_f5_s, 2
        ),
        "subepoch2_tile_s": round(subep_tile_s, 4),
        "subepoch2_tile_vs_baseline": round(
            BASELINE_EPOCH_S / subep_tile_s, 2
        ),
        "yelp_shape_s": round(yelp_s, 4),
        "yelp_shape_interactions_per_sec": round(1_561_406 / yelp_s),
        "gowalla_shape_s": round(gowalla_s, 4),
        "gowalla_shape_interactions_per_sec": round(1_027_370 / gowalla_s),
        # Sort-dedup huge-table path at the reduced 6M x 4.5M x 10M-click
        # geometry (time_large_epoch; bench_large.py's 16M x 6M x 40M
        # flagship stays the full-scale harness).
        "large_epoch_s": round(large_epoch_s, 4),
        "large_interactions_per_sec": round(
            large_geom["clicks"] / large_epoch_s
        ),
        "large_geometry": large_geom,
        # Reference run shape: 5 epochs + evals after epochs 2 and 4
        # (cf/main.py:106-124). Baseline ratio vs the epochs-only total
        # (5 x 245 s; the reference's eval time is unmeasured and
        # conservatively excluded).
        "full_run_s": round(full_run_s, 4),
        "full_run_ref_s": 5 * BASELINE_EPOCH_S,
        "full_run_vs_baseline": round(5 * BASELINE_EPOCH_S / full_run_s, 2),
        "full_run_fused_s": round(full_run_fused_s, 4),
        "full_run_fused_vs_baseline": round(
            5 * BASELINE_EPOCH_S / full_run_fused_s, 2
        ),
        # Same schedule at the reference's DEFAULT config shape
        # (tile + 2 sub-epochs, cf_config.py:7); fused = ONE device
        # program over the on-device-bucketed sub-epoch epoch.
        "full_run_default_s": round(full_run_def_s, 4),
        "full_run_default_fused_s": round(full_run_def_fused_s, 4),
        "full_run_default_fused_vs_baseline": round(
            5 * BASELINE_EPOCH_S / full_run_def_fused_s, 2
        ),
        "zipf_s": round(zipf_s, 4),
        "zipf_vs_baseline": round(BASELINE_EPOCH_S / zipf_s, 2),
        "zipf_exact_s": round(zipf_exact_s, 4),
        "zipf_exact_vs_baseline": round(BASELINE_EPOCH_S / zipf_exact_s, 2),
        "eval_topk50_s": round(eval_s, 4),
        "eval_skew_s": round(eval_skew_s, 4),
        # Serving request-path latency (ids in -> ranked top-20 ids on
        # host out, transfers included; batch 1 = the fixed dispatch
        # floor, batch 8192 = the marginal per-user cost).
        "serve_b1_ms": round(serve[1] * 1e3, 2),
        "serve_b256_ms": round(serve[256] * 1e3, 2),
        "serve_b8192_ms": round(serve[8192] * 1e3, 2),
        "serve_us_per_user_b8192": round(serve[8192] / 8192 * 1e6, 1),
        # Roofline (modeled algorithmic bytes / measured s vs the
        # device's published HBM peak; see modeled_epoch_bytes for what is
        # counted).
        "hbm_gb_modeled": round(head_gb, 2),
        "hbm_gbps": round(head_gb / direct_s, 1),
        "hbm_peak_frac": round(
            head_gb * 1e9 / direct_s / peaks["hbm_bytes_per_s"], 3
        ),
        "hbm_gbps_exact": round(exact_gb / exact_s, 1),
        "rows_gathered_headline": modeled_rows_gathered("headline"),
        "rows_gathered_exact": modeled_rows_gathered("exact"),
        "times": [round(t, 4) for t in direct_times],
    }
    result["device"] = device_record()
    # On-device hazard-regression tier last (timings above are
    # undisturbed; require_gpu above made sure this is a GPU); in-process
    # because one JAX process holds the card.
    passed, failed, skipped = run_gpu_tier()
    result["gpu_tests_passed"] = passed
    result["gpu_tests_failed"] = failed
    result["gpu_tests_skipped"] = skipped
    print(json.dumps(result))


if __name__ == "__main__":
    main()
