"""Smoke run of heat_cf's main path on one GPU, checked against plain references.

    python chip_smoke.py                 # one card (the default)
    python chip_smoke.py --four-cards    # only the sharded path, on four cards

A JAX process reserves most of a card's memory, so this script is the only
process on the card; the on-device test tier runs inside it. It refuses to
run where JAX finds no GPU. Every phase raises on failure, so any failed
phase makes the script exit non-zero without printing the result line.

The tier's program-against-program tests (marker ``deterministic``) need
XLA's deterministic GPU lowering (``--xla_gpu_deterministic_ops=true``),
which XLA reads once per process and which slows the main path's
full-size scatter-adds by orders of magnitude (an AmazonBooks epoch took
360 s instead of 0.07 s on an H100). So the script first runs those tests
in a child process started with the flag, which holds the card alone and
exits; then this process takes the card and runs everything else under
the default lowering, the one users run.

The default run works at the AmazonBooks MF_CCL widths
(benchmarks/AmazonBooks/config0.yaml: 52,643 users x 91,599 items, d=64,
16 negatives, max_his 100, batch 8192) on planted-cluster data made from
the config's seed, and uses exactly one card (the first visible one):

1. one train step against the sequential numpy oracle (tests/oracle.py),
   and the headline bf16 step against the f32 plain step;
2. training through the CLI entry point (heat_cf.main.main) under the
   config as shipped and under the headline treatment (tile sampler,
   per-epoch cached history means, bf16 tables and scoring, direct
   updates): per-epoch losses, epoch seconds and final Recall@20;
3. for each treatment, Engine training and evaluation and
   Recommender.recommend at batch 1 and 256, with the compiled memory
   plan of the epoch, eval and serve programs, checked against a host
   float64 ranking and against recommend_all;
4. the plain XLA history gather and ``history_mean_fused`` timed at the
   headline widths, with their modeled bytes against the card's peak;
5. the huge-table sort-dedup update path at bench_large.py's geometry
   (16M x 6M, d=64, bf16), and that path against the dense-accumulator
   path on one batch;
6. the rest of the on-device test tier (tests_gpu/), in-process.

Every printed number carries the card's name and power limit. The last
line of stdout is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "benchmarks", "AmazonBooks", "config0.yaml")
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
USERS, ITEMS = 52_643, 91_599
# The headline treatment, as --set overrides of the shipped config.
HEADLINE = {
    "neg_sampler": 1,
    "his_refresh": "subepoch",
    "param_dtype": "bfloat16",
    "compute_dtype": "bfloat16",
    "update_mode": "direct",
}
TREATMENTS = {"shipped": {}, "headline": HEADLINE}
CLI_EPOCHS = 3


class SmokeFailure(RuntimeError):
    """A phase's result is wrong."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class Report:
    """Prints one line per result, tagged with the card it ran on."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, phase: str, **fields) -> None:
        body = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        print(f"[{self.card}] {phase}: {body}", flush=True)

    def memory(self, phase: str, compiled) -> None:
        m = compiled.memory_analysis()
        self(
            phase,
            argument_bytes=m.argument_size_in_bytes,
            output_bytes=m.output_size_in_bytes,
            alias_bytes=m.alias_size_in_bytes,
            temp_bytes=m.temp_size_in_bytes,
            generated_code_bytes=m.generated_code_size_in_bytes,
        )

    def peak(self, phase: str) -> None:
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        self(phase, peak_bytes_in_use=stats.get("peak_bytes_in_use"))


def _fmt(v):
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_fmt(x) for x in v) + "]"
    return str(v)


class Recorder:
    """Stands in for a jitted function, records the argument shapes of its
    last call and lowers + compiles for them (a cache hit after the call)
    to read the compiled memory plan."""

    def __init__(self, fn):
        self.fn = fn
        self.specs = None

    def __call__(self, *args, **kwargs):
        import jax

        def spec(x):
            if isinstance(x, jax.Array):
                return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=x.sharding)
            return x

        # Before the call: donated arguments are deleted by it.
        self.specs = jax.tree.map(spec, (args, kwargs))
        return self.fn(*args, **kwargs)

    def compiled(self):
        check(self.specs is not None, "recorded program was never called")
        args, kwargs = self.specs
        return self.fn.lower(*args, **kwargs).compile()


# --- one-card phases ---------------------------------------------------------


def _oracle_problem(cfg, rng, batch):
    """Full-width tables and a batch whose users, positives and negatives
    are all distinct and disjoint from every history id, so the batched
    step and the sequential oracle read the same rows."""
    d, negs = cfg.emb_dim, cfg.num_negs
    user_emb = rng.normal(0, 1e-2, (cfg.num_users, d)).astype(np.float32)
    item_emb = rng.normal(0, 1e-2, (cfg.num_items, d)).astype(np.float32)
    w0 = rng.normal(0, 1e-2, (d, d)).astype(np.float32)
    touched = batch * (1 + negs)
    check(touched < cfg.num_items, "item table too small for a disjoint batch")
    his_items = rng.integers(
        touched, cfg.num_items, (cfg.num_users, cfg.max_his)
    ).astype(np.int32)
    his_masks = rng.integers(1, cfg.max_his + 1, cfg.num_users).astype(np.int32)
    users = rng.choice(cfg.num_users, batch, replace=False).astype(np.int32)
    items = rng.permutation(touched).astype(np.int32)
    pos, neg = items[:batch], items[batch:].reshape(batch, negs)
    return user_emb, item_emb, w0, his_items, his_masks, users, pos, neg


def _batched_step(cfg, tables, his_items, his_masks, users, pos, negs,
                  user_means=None):
    """One jitted train_step with the negatives pinned (sampler stubbed)."""
    import jax
    import jax.numpy as jnp

    import heat_cf.train.train_step as ts
    from heat_cf.models.state import TrainState
    from heat_cf.train.samplers import NegSample, SamplerState

    user_emb, item_emb, w0 = tables
    dtype = jnp.dtype(cfg.param_dtype)
    state = TrainState(
        user_emb=jnp.asarray(user_emb, dtype),
        item_emb=jnp.asarray(item_emb, dtype),
        w0=jnp.asarray(w0),
        user_gacc=None,
        item_gacc=None,
        lr=jnp.asarray(cfg.l_r, jnp.float32),
        step=jnp.asarray(0, jnp.int32),
    )
    sstate = SamplerState(
        tile=jnp.zeros((1,), jnp.int32), iterations=jnp.asarray(0, jnp.int32)
    )
    batch = ts.Batch(
        jnp.asarray(users), jnp.asarray(pos), jnp.ones(len(users), jnp.float32)
    )
    negs_j = jnp.asarray(negs)
    orig = ts.sample_negatives
    ts.sample_negatives = lambda key, st, p, c, real=None: (
        NegSample(negs_j, None, None), st
    )
    try:
        step = jax.jit(
            lambda st, ss, b, hi, hm, um: ts.train_step(
                st, ss, jax.random.key(0), b, hi, hm, cfg, user_means=um
            )
        )
        state, _, loss = step(
            state, sstate, batch, jnp.asarray(his_items),
            jnp.asarray(his_masks), user_means,
        )
    finally:
        ts.sample_negatives = orig
    return (
        np.asarray(state.user_emb, np.float32),
        np.asarray(state.item_emb, np.float32),
        np.asarray(state.w0, np.float32),
        float(loss),
    )


def oracle_step_phase(report, users=USERS, items=ITEMS, batch=1024, seed=0):
    """One f32 train step against tests/oracle.py, and the headline bf16
    step against the f32 plain step, on the same disjoint batch."""
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle

    from heat_cf.config import load_config
    from heat_cf.train.engine import compute_user_pools

    # aggr_minibatch = batch: the reference applies w0 once per 32 samples,
    # the batched step once per batch; with one cadence both read the same
    # w0 for every sample.
    cfg, _ = load_config(
        CONFIG, num_users=users, num_items=items, aggr_minibatch=batch
    )
    rng = np.random.default_rng(seed)
    ue, ie, w0, his, masks, u_ids, p_ids, n_ids = _oracle_problem(cfg, rng, batch)

    m = oracle.OracleModel.create(ue, ie, w0)
    want_loss = 0.0
    for i in range(batch):
        want_loss += oracle.forward_backward(
            m, int(u_ids[i]), int(p_ids[i]), list(n_ids[i]), his, masks,
            lr=cfg.l_r, clip_val=cfg.clip_val, gamma=cfg.gamma,
            score_mul=cfg.score_mul, aggr_minibatch=cfg.aggr_minibatch,
        )
    got_u, got_i, got_w0, got_loss = _batched_step(
        cfg, (ue, ie, w0), his, masks, u_ids, p_ids, n_ids
    )
    # Bound: each touched row is written once, from the same f32 inputs, so
    # the two differ only by f32 summation order (the batched step sums
    # d=64 and K=16 terms in tree order; w0's update sums 1024 outer
    # products; near-zero elements carry the absolute part of the error).
    # rtol 1e-5 with an atol of 5e-5 of the 1e-2 init scale (5e-7) covers
    # that, and a TF32 (10-bit mantissa) product anywhere in the step
    # would not pass: its error is ~5e-4 relative.
    rtol, atol = 1e-5, 5e-7
    report(
        "oracle_step_f32",
        batch=batch, rtol=rtol, atol=atol, precision="f32 HIGHEST",
        loss=got_loss, oracle_loss=want_loss,
        max_abs_user=float(np.max(np.abs(got_u - m.user_emb))),
        max_abs_item=float(np.max(np.abs(got_i - m.item_emb))),
        max_abs_w0=float(np.max(np.abs(got_w0 - m.w0))),
    )
    np.testing.assert_allclose(got_loss, want_loss, rtol=rtol)
    np.testing.assert_allclose(got_u, m.user_emb, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_i, m.item_emb, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_w0, m.w0, rtol=rtol, atol=atol)

    # Headline step: bf16 tables + bf16 scoring + direct updates + history
    # means from the cached pools table, against the f32 plain step.
    hcfg = dataclasses.replace(
        cfg, param_dtype="bfloat16", compute_dtype="bfloat16",
        update_mode="direct", his_refresh="subepoch",
    )
    pools = compute_user_pools(
        jnp.asarray(ie, jnp.bfloat16), jnp.asarray(his), jnp.asarray(masks),
        max_his=cfg.max_his,
    )
    b_u, b_i, b_w0, b_loss = _batched_step(
        hcfg, (ue, ie, w0), his, masks, u_ids, p_ids, n_ids, user_means=pools
    )

    def update_err(b_tab, f_tab, init):
        # Relative error of the step's update (new - old rows), in norm.
        f_upd = f_tab - init
        b_upd = b_tab - np.asarray(jnp.asarray(init, jnp.bfloat16), np.float32)
        return float(np.linalg.norm(b_upd - f_upd) / np.linalg.norm(f_upd))

    # Bound: the bf16 step rounds the tables, the pooled means, the scoring
    # operands and the stored rows to 8 mantissa bits (2^-8 relative per
    # rounding). Element-wise, a gradient component that is a small
    # difference of large cosine terms (|grad| ~ score_mul / |u| ~ 1e2 at
    # init) can differ by far more than that, so the table rows are
    # compared through the update they received: its norm-relative error
    # must stay within 2^-5. w0 stays f32 and takes a tiny update (a sum
    # of 1024 outer products that mostly cancel), so w0 itself is compared
    # at one bf16 rounding, 2^-8; the loss within 2^-6 (four roundings).
    loss_rtol, upd_rtol, w0_rtol = 2.0**-6, 2.0**-5, 2.0**-8
    err_u = update_err(b_u, got_u, ue)
    err_i = update_err(b_i, got_i, ie)
    report(
        "headline_step_bf16_vs_f32",
        batch=batch, loss_rtol=loss_rtol, update_norm_rtol=upd_rtol,
        w0_rtol=w0_rtol,
        precision="bf16 tables and scoring, f32 accumulation",
        loss=b_loss, f32_loss=got_loss, update_err_user=err_u,
        update_err_item=err_i,
        max_abs_w0=float(np.max(np.abs(b_w0 - got_w0))),
    )
    np.testing.assert_allclose(b_loss, got_loss, rtol=loss_rtol)
    check(max(err_u, err_i) <= upd_rtol,
          f"bf16 step update error {err_u}, {err_i} > {upd_rtol}")
    np.testing.assert_allclose(b_w0, got_w0, rtol=w0_rtol, atol=w0_rtol * 1e-3)


def cli_phase(report, name, overrides, users=USERS, items=ITEMS,
              epochs=CLI_EPOCHS):
    """Train through ``heat_cf.main.main`` (the CLI) and read its log."""
    from heat_cf.main import main as cli_main

    os.makedirs(OUT_DIR, exist_ok=True)
    log = os.path.join(OUT_DIR, f"cli_{name}.jsonl")
    if os.path.exists(log):
        os.remove(log)
    argv = [
        "--config", CONFIG, "--synthetic", f"{users},{items}",
        "--epochs", str(epochs), "--log-file", log,
    ]
    for key, value in overrides.items():
        argv += ["--set", f"{key}={value}"]
    t0 = time.perf_counter()
    cli_main(argv)
    wall = time.perf_counter() - t0
    with open(log) as fh:
        events = [json.loads(line) for line in fh]
    losses = [e["loss"] for e in events if e["event"] == "epoch"]
    secs = [e["epoch_time_s"] for e in events if e["event"] == "epoch"]
    final = [e for e in events if e["event"] == "final_eval"][-1]
    recall = final["Recall(k=20)"]
    # A random ranking recalls ~20/items of a user's held-out items.
    floor = 5 * 20 / items
    report(
        f"cli_train_{name}", epochs=epochs, losses=losses,
        epoch_seconds_info_only=secs, final_recall20=recall,
        recall_floor=floor, wall_s_with_setup_and_compile=wall,
    )
    check(len(losses) == epochs, f"{name}: {len(losses)} epochs logged")
    check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{name}: loss did not fall {losses}")
    check(recall > floor, f"{name}: Recall@20 {recall} <= {floor}")


def _host_topk_check(phase, report, ids, user_rows, item_rows, seen, k,
                     extra=None):
    """Tie-aware check of device top-k ids against a host float64 ranking:
    the host scores of the returned ids must equal, rank by rank, the k
    best host scores (so tied or near-tied items may come in any order),
    and no seen item may be returned."""
    sim = user_rows.astype(np.float64) @ item_rows.astype(np.float64).T
    for r, s in enumerate(seen):
        sim[r, list(s)] = -np.inf
    want = -np.sort(-sim, axis=1)[:, :k]
    got = np.take_along_axis(sim, np.asarray(ids, np.int64), axis=1)
    # f32 products of d terms against f64: relative 1e-5 of the row's
    # largest score covers accumulation order; a TF32 GEMM would not pass.
    rtol = 1e-5
    atol = 1e-5 * float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want))) if np.all(np.isfinite(got)) else float("inf")
    report(phase, users=len(seen), k=k, rtol=rtol, atol=atol,
           precision="f32 HIGHEST vs host f64", max_abs_err=err,
           **(extra or {}))
    check(np.all(np.isfinite(got)), f"{phase}: a seen item was returned")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _seen_sets(pairs, uids):
    want = set(int(u) for u in uids)
    seen = {u: set() for u in want}
    for u, i in np.asarray(pairs):
        if int(u) in want:
            seen[int(u)].add(int(i))
    return [seen[int(u)] for u in uids]


def engine_phase(report, name, overrides, users=USERS, items=ITEMS,
                 check_users=300, seed=0):
    """Engine training/evaluation and Recommender serving, with the
    compiled memory plans and the host-oracle comparisons."""
    import jax

    import heat_cf.evaluation.evaluator as ev_mod
    import heat_cf.serving as serving
    from heat_cf.config import load_config
    from heat_cf.data.synthetic import synthetic_click_dataset
    from heat_cf.evaluation.evaluator import TiledEvaluator
    from heat_cf.train.engine import Engine

    cfg, _ = load_config(CONFIG, **overrides)
    train, test = synthetic_click_dataset(
        num_users=users, num_items=items, max_his=cfg.max_his, seed=cfg.seed
    )
    engine = Engine(cfg, train, test)
    engine._epoch_fn = epoch_rec = Recorder(engine._epoch_fn)
    orig_eval, orig_req = ev_mod._topk_all_tiles, serving._topk_request
    ev_mod._topk_all_tiles = eval_rec = Recorder(orig_eval)
    serving._topk_request = req_rec = Recorder(orig_req)
    try:
        t0 = time.perf_counter()
        loss = engine.train_one_epoch()
        t_epoch = time.perf_counter() - t0
        metrics = engine.evaluate()
        report(f"engine_{name}", epoch_loss=loss,
               epoch_s_with_compile_info_only=t_epoch, **{
                   k.replace("(", "_").replace(")", "").replace("=", ""): v
                   for k, v in metrics.items()})
        check(np.isfinite(loss), f"engine {name}: loss {loss}")
        check(all(np.isfinite(list(metrics.values()))), f"metrics {metrics}")
        report.memory(f"memory_epoch_program_{name}", epoch_rec.compiled())
        report.memory(f"memory_eval_program_{name}", eval_rec.compiled())

        # Exact top-50 eval against a host float64 ranking.
        ue = np.asarray(engine.state.user_emb, np.float32)
        ie = np.asarray(engine.state.item_emb, np.float32)
        ev = TiledEvaluator(train.pairs, users, num_items=items)
        _, ids = ev.topk(ue, ie, 50, return_scores=True)
        rng = np.random.default_rng(seed)
        uids = rng.choice(users, check_users, replace=False)
        _host_topk_check(
            f"eval_top50_vs_host_{name}", report, ids[uids], ue[uids], ie,
            _seen_sets(train.pairs, uids), 50,
        )

        # Serving: recommend at batch 1 and 256 against recommend_all and
        # the host ranking.
        rec = serving.Recommender.from_engine(engine)
        k = 20
        ids_all = rec.recommend_all(k)
        for b in (1, 256):
            req = rng.choice(users, b, replace=False)
            got = rec.recommend(req, k)
            t0 = time.perf_counter()
            reps = 20
            for _ in range(reps):
                rec.recommend(req, k)
            ms = (time.perf_counter() - t0) / reps * 1e3
            same = float(np.mean(got == ids_all[req]))
            _host_topk_check(
                f"recommend_b{b}_vs_host_{name}", report, got, ue[req], ie,
                _seen_sets(train.pairs, req), k,
                extra={"equal_to_recommend_all": same,
                       "request_ms_info_only": ms},
            )
            _host_topk_check(
                f"recommend_all_b{b}_vs_host_{name}", report, ids_all[req],
                ue[req], ie, _seen_sets(train.pairs, req), k,
            )
        report.memory(f"memory_serve_program_{name}", req_rec.compiled())
    finally:
        ev_mod._topk_all_tiles, serving._topk_request = orig_eval, orig_req
    del engine, rec, ev
    gc.collect()
    report.peak(f"after_engine_{name}")


def _time_calls(fn, *args, calls=50, rounds=5):
    import jax

    jax.block_until_ready(fn(*args))
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / calls)
    return float(np.median(per))


def plain_gather_phase(report, peak_bytes_per_s, batch=8192, his=100,
                       items=ITEMS, d=64):
    """Times what XLA makes of the per-step history read at the headline
    widths: the plain row gather of a B*H-row history batch, and
    ``history_mean_fused``. Prints time, modeled bytes and the share of the
    card's peak bandwidth (the number a hand-written kernel must beat)."""
    import jax
    import jax.numpy as jnp

    from heat_cf.models.aggregator import history_mean_fused

    k1, k2 = jax.random.split(jax.random.key(0))
    table = jax.random.normal(k1, (items, d), jnp.float32) * 1e-2
    ids = jax.random.randint(k2, (batch, his), 0, items, jnp.int32)
    masks = jnp.full((batch,), his, jnp.int32)
    rows = batch * his
    row_bytes = d * 4
    table_bytes = items * row_bytes
    # Two byte models. "all rows": every gathered row comes from device
    # memory. "table once": the table (23 MB at these widths) fits the
    # H100's 50 MB L2, so device memory sees it once, plus the ids and
    # the output; that is the bound a kernel has to meet.
    cases = {
        "xla_row_gather": (
            jax.jit(lambda t, i: t[i.reshape(-1)]), (table, ids),
            rows * 4 + 2 * rows * row_bytes,
            table_bytes + rows * 4 + rows * row_bytes,
        ),
        "history_mean_fused": (
            jax.jit(history_mean_fused), (table, ids, masks),
            rows * 4 + batch * 4 + rows * row_bytes + batch * row_bytes,
            table_bytes + rows * 4 + batch * 4 + batch * row_bytes,
        ),
    }
    for name, (fn, args, all_rows, table_once) in cases.items():
        secs = _time_calls(fn, *args)
        shares = (all_rows / secs / peak_bytes_per_s,
                  table_once / secs / peak_bytes_per_s)
        report(
            f"plain_{name}", rows=rows, d=d, dtype="float32",
            time_us=secs * 1e6, bytes_all_rows=all_rows,
            bytes_table_once=table_once,
            GBps_all_rows=all_rows / secs / 1e9,
            GBps_table_once=table_once / secs / 1e9,
            hbm_share_all_rows=shares[0], hbm_share_table_once=shares[1],
        )
        check(np.isfinite(secs) and secs > 0, f"{name}: time {secs}")


def sort_dedup_phase(report, users=16_000_000, items=6_000_000,
                     steps=4, batch=32_768, epochs=2, seed=0):
    """The huge-table sort-dedup update path at bench_large.py's geometry
    (both tables above DENSE_ROWS_THRESHOLD): a few steps through the
    Engine, then the sort path against the dense-accumulator path on one
    batch of the trained user table."""
    import jax
    import jax.numpy as jnp

    import bench_large
    from heat_cf.train import scatter
    from heat_cf.train.engine import Engine

    check(min(users, items) > scatter.DENSE_ROWS_THRESHOLD,
          "geometry does not reach the sort-dedup path")
    cfg = bench_large.make_config(batch=batch, refresh=batch)
    data = bench_large.make_dataset(users, items, steps * batch, cfg.max_his,
                                    seed=seed)
    engine = Engine(cfg, data)
    del data
    t0 = time.perf_counter()
    losses = [engine.train_one_epoch() for _ in range(epochs)]
    wall = time.perf_counter() - t0
    report("sort_dedup_engine", users=users, items=items, d=cfg.emb_dim,
           width=engine.state.user_emb.shape[1], dtype=cfg.param_dtype,
           steps_per_epoch=steps, losses=losses,
           wall_s_with_compile_info_only=wall)
    check(all(np.isfinite(losses)), f"sort-dedup losses {losses}")
    table = engine.state.user_emb
    del engine
    gc.collect()

    # One batch with many duplicate ids (half drawn from 1024 hot rows).
    rng = np.random.default_rng(seed + 1)
    ids = np.concatenate([
        rng.integers(0, 1024, batch // 2), rng.integers(0, users, batch // 2)
    ]).astype(np.int32)
    width, d = table.shape[1], cfg.emb_dim
    grads = np.zeros((batch, width), np.float32)
    grads[:, :d] = rng.normal(0, 1.0, (batch, d))
    # Write-back rows are a function of the id, as in training, where
    # every occurrence of a user carries the same aggregated row.
    wb_of = rng.normal(0, 1e-2, (1024, width)).astype(np.float32)
    wb_of[:, d:] = 0
    writeback = wb_of[ids % 1024]
    kw = dict(lr=jnp.float32(cfg.l_r), clip_val=cfg.clip_val, gacc=None,
              decay=1.0, l2=0.0)

    def sorted_update(t, i, g, w):
        return scatter._apply_row_updates_sorted(t, i, g, writeback=w, **kw)[0]

    def dense_update(t, i, g, w):
        if w is not None:  # apply_row_updates' dense-path write-back
            t = t.at[i].set(w.astype(t.dtype), mode="drop")
        return scatter._apply_row_updates_dense(t, i, g, **kw)[0]

    sorted_fn, dense_fn = jax.jit(sorted_update), jax.jit(dense_update)
    uniq = np.unique(ids)
    untouched = np.setdiff1d(rng.integers(0, users, 4096), uniq)
    ids_j, g_j = jnp.asarray(ids), jnp.asarray(grads)
    for label, wb in (("plain", None), ("writeback", writeback)):
        wb_j = None if wb is None else jnp.asarray(wb)
        got = sorted_fn(table, ids_j, g_j, wb_j)
        want = dense_fn(table, ids_j, g_j, wb_j)
        got_rows = np.asarray(got[uniq], np.float32)
        want_rows = np.asarray(want[uniq], np.float32)
        base = (
            np.asarray(table[uniq], np.float32) if wb is None
            else wb_of[uniq % 1024]
        )
        # Bound: both sum each id's duplicates in f32, in different orders
        # (sorted segment-sum vs scatter-add), and round to bf16: the
        # dense path rounds the write-back row, the increment and the
        # result, the sorted path the result only. A bf16 rounding errs by
        # at most 2^-8 relative, and the row, the increment (at most
        # lr * clip_val) and either result are each at most
        # |row| + lr * clip_val, so the two are at most four roundings,
        # 4 * 2^-8 * (|row| + lr * clip_val), apart.
        bound = 2.0**-6 * (np.abs(base) + cfg.l_r * cfg.clip_val)
        excess = float(np.max(np.abs(got_rows - want_rows) - bound))
        report(
            f"sort_dedup_vs_dense_{label}", batch=batch,
            unique_ids=len(uniq), bound="2^-6*(|row|+lr*clip)",
            precision="f32 sums, bf16 table",
            max_abs_diff=float(np.max(np.abs(got_rows - want_rows))),
            max_excess_over_bound=excess,
        )
        check(excess <= 0, f"sort-dedup vs dense ({label}) beyond bound")
        np.testing.assert_array_equal(
            np.asarray(got[untouched]), np.asarray(table[untouched])
        )
        np.testing.assert_array_equal(
            np.asarray(want[untouched]), np.asarray(table[untouched])
        )
        del got, want
    del table
    gc.collect()
    report.peak("after_sort_dedup")


def tier_phase(report, marks):
    """The on-device tier's tests selected by ``marks`` (a pytest -m
    expression), in this process; none may fail or skip."""
    from bench import run_gpu_tier

    passed, failed, skipped = run_gpu_tier(marks)
    report(f"gpu_tier[{marks}]", passed=passed, failed=failed,
           skipped=skipped)
    check(failed == 0 and skipped == 0 and passed > 0,
          f"tier: {passed} passed, {failed} failed, {skipped} skipped")


def run_deterministic_tier() -> None:
    """Runs the tier's ``deterministic`` tests in a child process started
    with the deterministic lowering, and waits for it: it must exit 0. It
    refuses the CPU as this script does."""
    import subprocess

    from heat_cf.utils.device import DETERMINISTIC_OPS_FLAG

    env = dict(os.environ)
    env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} {DETERMINISTIC_OPS_FLAG}".strip()
    rc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--deterministic-tier"],
        env=env, check=False,
    ).returncode
    if rc != 0:
        sys.exit(f"chip_smoke: the deterministic tier process exited {rc}")


# --- four-card phase ---------------------------------------------------------


def _sharded_rows_check(report, phase, got, want, init, steps, **extra):
    """Every row of a table trained on a mesh against the same row trained
    on one card, in norm, relative to the update the row received there.

    Bound: the mesh sums each batch's contributions to a row in another
    order than one card, and the cosine gradients (~1e2 before the clip)
    amplify that f32 noise over the steps, so a row may miss its one-card
    value by a small share of its update. A sharding fault (a wrong shard
    offset, a lost or doubled shard update) moves a row by a whole step's
    update, at least 1/steps of its total. So each row must lie within
    tau = 0.1 of its update norm (plus 1e-6 for rows the steps did not
    touch, which must not move). The comparison is checked against a
    planted fault: the rows of one of four shards lose 1/steps of their
    update, and the check must flag them."""
    tau, floor = 0.1, 1e-6

    def errors(table):
        return np.linalg.norm(table - want, axis=1)

    upd = np.linalg.norm(want - init, axis=1)
    err = errors(got)
    touched = upd > 0
    ratio = err[touched] / upd[touched]
    ok = err <= tau * upd + floor
    shard = slice(0, len(got) // 4)
    faulty = got.copy()
    faulty[shard] -= (want[shard] - init[shard]) / steps
    flagged = ~(errors(faulty) <= tau * upd + floor)
    flagged_share = float(np.mean(flagged[shard][touched[shard]]))
    report(
        phase, rows=len(got), touched_rows=int(touched.sum()), tau=tau,
        floor=floor, max_err_over_update=float(ratio.max()),
        p99_err_over_update=float(np.quantile(ratio, 0.99)),
        max_err_untouched=float(err[~touched].max(initial=0.0)),
        max_abs=float(np.max(np.abs(got - want))),
        rows_over_bound=int((~ok).sum()),
        planted_fault_rows_flagged=flagged_share, **extra,
    )
    check(ok.all(), f"{phase}: {int((~ok).sum())} rows beyond the bound")
    check(flagged_share == 1.0,
          f"{phase}: planted fault flagged on {flagged_share} of its rows")


def four_cards_phase(report, devices, users=USERS, items=ITEMS, steps=4,
                     batch=8192, check_users=256, seed=0):
    """The sharded path users run on several cards, against one card: a
    few AmazonBooks-width steps under the CLI's mesh (global_mesh, 4x1) and
    a 2x2 mesh, evaluate(), the shard_map top-k, and
    Recommender.from_engine."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from heat_cf.config import load_config
    from heat_cf.data.synthetic import synthetic_click_dataset
    from heat_cf.evaluation.evaluator import (
        TiledEvaluator,
        pack_train_bits,
        sharded_pad_items,
        sharded_topk,
    )
    from heat_cf.evaluation.metrics import evaluate_metrics
    from heat_cf.parallel.distributed import global_mesh
    from heat_cf.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
    from heat_cf.serving import Recommender
    from heat_cf.train.engine import Engine

    cfg, _ = load_config(CONFIG)
    train, test = synthetic_click_dataset(
        num_users=users, num_items=items, max_his=cfg.max_his, seed=cfg.seed
    )
    train = dataclasses.replace(train, pairs=train.pairs[: steps * batch])
    cfg.batch_size = batch
    metrics = ["Recall(k=20)", "NDCG(k=20)"]

    def engine_on(mesh):
        return Engine(dataclasses.replace(cfg), train, test, mesh=mesh)

    one = engine_on(None)
    init_u = np.asarray(one.state.user_emb)
    init_i = np.asarray(one.state.item_emb)
    one_loss = one.train_one_epoch()
    one_u = np.asarray(one.state.user_emb)
    one_i = np.asarray(one.state.item_emb)
    rng = np.random.default_rng(seed)
    req = rng.choice(users, check_users, replace=False)
    meshes = {
        "global_mesh_4x1": global_mesh(),
        "mesh_2x2": make_mesh(2, 2, devices),
    }
    for name, mesh in meshes.items():
        check(mesh.devices.size == 4, f"{name}: {mesh.devices.size} devices")
        eng = engine_on(mesh)
        loss = eng.train_one_epoch()
        st = eng.unpadded_state()
        u = np.asarray(st.user_emb)
        i = np.asarray(st.item_emb)
        np.testing.assert_allclose(loss, one_loss, rtol=1e-4)
        for table, got, want, init in (
            ("user", u, one_u, init_u), ("item", i, one_i, init_i)
        ):
            _sharded_rows_check(report, f"four_cards_train_{name}_{table}",
                                got, want, init, steps, loss=loss,
                                one_card_loss=one_loss, loss_rtol=1e-4)

        # evaluate() on the mesh against the one-card evaluator on the
        # same (gathered) tables: same ranking, same metric values.
        got = eng.evaluate(metrics)
        _, ids = TiledEvaluator(train.pairs, users, num_items=items).topk(
            u, i, 20
        )
        want = evaluate_metrics(metrics, ids, test.user_items)
        report(f"four_cards_evaluate_{name}", tol=1e-6,
               **{m.split("(")[0]: got[m] for m in metrics},
               **{"one_card_" + m.split("(")[0]: want[m] for m in metrics})
        for m in metrics:
            check(abs(got[m] - want[m]) < 1e-6, f"{name} {m}: {got} {want}")

        # The shard_map top-k (the multi-host evaluator's kernel) on this
        # mesh against the host ranking; it needs a user count divisible
        # by the data axis, so it ranks the largest such prefix.
        pad = sharded_pad_items(mesh, items)
        n_data = mesh.shape[DATA_AXIS]
        u_rows = (users // n_data) * n_data
        bits = pack_train_bits(
            train.pairs[train.pairs[:, 0] < u_rows], u_rows, items,
            pad_items=pad,
        )
        i_pad = np.zeros((pad, i.shape[1]), i.dtype)
        i_pad[:items] = i
        s_sh, ids_sh = sharded_topk(
            mesh,
            jax.device_put(u[:u_rows], NamedSharding(mesh, P(DATA_AXIS, None))),
            jax.device_put(i_pad, NamedSharding(mesh, P(MODEL_AXIS, None))),
            jax.device_put(bits, NamedSharding(mesh, P(DATA_AXIS, None))),
            50,
        )
        sub = req[req < u_rows]
        _host_topk_check(
            f"four_cards_sharded_topk_{name}", report,
            np.asarray(ids_sh)[sub], u[sub], i,
            _seen_sets(train.pairs, sub), 50,
        )

        # Serving from the live sharded engine against a one-card
        # Recommender on the same tables.
        rec_mesh = Recommender.from_engine(eng)
        one_state = jax.device_put(st, devices[0])
        rec_one = Recommender(one_state, cfg, seen_pairs=train.pairs)
        got_ids = rec_mesh.recommend(req, 20)
        want_ids = rec_one.recommend(req, 20)
        report(f"four_cards_recommend_{name}", batch=len(req),
               equal_fraction=float(np.mean(got_ids == want_ids)))
        _host_topk_check(
            f"four_cards_recommend_vs_host_{name}", report, got_ids, u[req],
            i, _seen_sets(train.pairs, req), 20,
        )
        del eng, rec_mesh, rec_one
        gc.collect()


# --- entry -------------------------------------------------------------------


def result_line(devices) -> str:
    """The last line of stdout: what ran, as JAX reports it."""
    d = devices[0]
    return json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform,
            "kind": d.device_kind,
            "count": len(devices),
        },
    })


def _visible_card_index() -> str:
    """The first card CUDA would expose (index or UUID), and pin the
    process to it, so every phase runs on that one card."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    first = (vis if vis is not None else "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = first
    return first


def gpu_devices(count: int):
    """The first ``count`` JAX devices; exits non-zero unless they are
    GPUs — this script never runs its phases on the CPU."""
    import jax

    from heat_cf.utils.device import require_gpu

    require_gpu()
    devices = jax.devices()
    if len(devices) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX found {len(devices)}")
    return devices[:count]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded path on four cards and its comparisons",
    )
    parser.add_argument(
        "--deterministic-tier", action="store_true",
        help="(the child process) run only the tier's deterministic tests",
    )
    args = parser.parse_args(argv)
    from heat_cf.utils.device import (
        deterministic_ops,
        device_peaks,
        gpu_name_and_power_limit,
    )

    index = None if args.four_cards else _visible_card_index()
    if not (args.four_cards or args.deterministic_tier):
        # Before this process touches the card, which it then keeps.
        run_deterministic_tier()
    devices = gpu_devices(4 if args.four_cards else 1)

    import jax

    from heat_cf.utils.cache import enable_compilation_cache

    card = gpu_name_and_power_limit(index).replace("\n", " | ")
    report = Report(card)
    report("setup", jax_version=jax.__version__,
           xla_flags=repr(os.environ.get("XLA_FLAGS", "")),
           device_kind=repr(devices[0].device_kind), count=len(jax.devices()),
           compile_cache=enable_compilation_cache())
    t_start = time.perf_counter()
    if args.deterministic_tier:
        check(deterministic_ops(), "started without the deterministic flag")
        tier_phase(report, "deterministic")
        report("done", wall_s=time.perf_counter() - t_start)
        return
    if args.four_cards:
        four_cards_phase(report, devices)
    else:
        oracle_step_phase(report)
        for name, overrides in TREATMENTS.items():
            cli_phase(report, name, overrides)
        for name, overrides in TREATMENTS.items():
            engine_phase(report, name, overrides)
        peaks = device_peaks(devices[0].device_kind)
        plain_gather_phase(report, peaks["hbm_bytes_per_s"])
        sort_dedup_phase(report)
        tier_phase(report, "not deterministic")
    report("done", wall_s=time.perf_counter() - t_start)
    print(f"card: {card}", flush=True)
    print(result_line(jax.devices()), flush=True)


if __name__ == "__main__":
    main()
