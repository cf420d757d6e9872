"""On-device regression tests for GPU numeric hazards.

Each test targets a bug class that CPU tests cannot catch (CPU matmuls are
exact f32; CPU scatters sum in a fixed order; CPU clamps out-of-range
slices consistently). On the GPU the forms are:

1. TF32: an f32 matmul at default precision keeps a 10-bit mantissa,
   which re-ranks near-tied top-k candidates and rounds pooled means;
2. atomic scatter order: by default duplicate-id scatter-adds sum with
   atomics in an order that changes from run to run, and SGD grows that
   f32 noise: on an H100 the same program run twice for two epochs ends
   with tables 7-29% apart in norm. The tests marked ``deterministic``
   compare two programs (padded, fused, remapped or deduplicated against
   the plain one) at the bounds the CPU suite uses, so they run under
   ``--xla_gpu_deterministic_ops=true``, where scatter-adds sum in a
   fixed order and the same program is bit-identical run to run;
3. slice clamping and layout: chunked loops whose last chunk would start
   out of range, and padded/fused program layouts.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from heat_cf.config import CFConfig
from heat_cf.data.datasets import ClickDataset
from heat_cf.data.synthetic import synthetic_click_dataset
from heat_cf.evaluation.evaluator import TiledEvaluator
from heat_cf.models.aggregator import user_pools_impl
from heat_cf.train.engine import Engine

pytestmark = pytest.mark.gpu


def test_pools_clamp_regression():
    """Chunked whole-table pooling must be exact for EVERY row, including
    the final partial chunk whose dynamic_slice start would clamp (a
    backend may clamp the read and the write to DIFFERENT offsets unless
    the start is clamped explicitly, shifting rows by the clamp delta),
    and the masked mean must not be computed in TF32. U is chosen
    prime-ish so no chunk size divides it."""
    rng = np.random.default_rng(0)
    U, I, D, H = 20_011, 50_000, 64, 100
    item = jnp.asarray(
        rng.normal(scale=0.01, size=(I, D)).astype(np.float32), jnp.bfloat16
    )
    his = rng.integers(0, I, (U, H)).astype(np.int32)
    masks = rng.integers(0, H + 1, (U,)).astype(np.int32)
    got = np.asarray(
        jax.jit(
            lambda it, hi, ms: user_pools_impl(it, hi, ms, aggregator="mean")
        )(item, jnp.asarray(his), jnp.asarray(masks)),
        np.float32,
    )
    # Independent numpy oracle from the same bf16 row values, rounded to
    # the pools' bf16 storage resolution: the device path accumulates the
    # masked sum and divides in f32, then rounds ONCE into the bf16 table,
    # so it may differ from the f32 oracle only by that single rounding
    # (1 bf16 ulp = 2^-8 relative; the rtol allows 2 ulps for boundary
    # flips where the f32 mean lands within accumulation-order noise of a
    # rounding boundary — measured 78/1.28M elements at <=2 ulp). A
    # clamp-shear regression shows up as whole rows taking ANOTHER row's
    # values — errors at 100% relative scale, far outside this band.
    item_np = np.asarray(item, np.float32)
    rows = item_np[his]  # (U, H, D)
    keep = (np.arange(H)[None, :] < masks[:, None]).astype(np.float32)
    want = (rows * keep[:, :, None]).sum(1) / np.maximum(
        masks[:, None], 1
    ).astype(np.float32)
    want[masks == 0] = 0.0
    want_b = np.asarray(jnp.asarray(want, jnp.bfloat16), np.float32)
    np.testing.assert_allclose(got, want_b, rtol=8e-3, atol=2e-6)


def test_exact_topk_matches_host_ranking():
    """The evaluator's exact two-phase top-k on the GPU must agree with
    a host-side f32 ranking of the same scores — catches any default-
    precision (TF32) matmul in the scoring or selection path re-ranking
    candidates whose scores differ below TF32 resolution."""
    rng = np.random.default_rng(1)
    U, I, D, K = 2048, 91_599, 64, 50
    # bf16-trained-table regime: score gaps frequently below bf16 ulp.
    ue = rng.normal(scale=0.05, size=(U, D)).astype(np.float32)
    ie = rng.normal(scale=0.05, size=(I, D)).astype(np.float32)
    pairs = np.stack(
        [rng.integers(0, U, 100_000), rng.integers(0, I, 100_000)], 1
    ).astype(np.int32)
    ev = TiledEvaluator(pairs, U, num_items=I)
    scores_dev, ids_dev = ev.topk(ue, ie, K, return_scores=True)
    # Host oracle: exact f32 GEMM + masking + argsort.
    sim = ue.astype(np.float64) @ ie.astype(np.float64).T
    sim = sim.astype(np.float32)
    sim[pairs[:, 0], pairs[:, 1]] = -np.inf
    kth = np.partition(-sim, K - 1, axis=1)
    want_scores = -kth[:, :K]
    want_scores.sort(axis=1)
    want_scores = want_scores[:, ::-1]
    np.testing.assert_allclose(scores_dev, want_scores, rtol=1e-5)
    # The ids' gathered scores must equal the returned scores (no silent
    # re-ranking between selection and extraction).
    np.testing.assert_allclose(
        np.take_along_axis(sim, np.asarray(ids_dev), 1),
        scores_dev,
        rtol=1e-5,
    )


def test_direct_vs_dedup_metrics_agree():
    """update_mode='direct' (per-occurrence scatter-add, atomics on the
    GPU) and 'dedup' (combine-then-clip) must agree on end metrics within
    a small band (full-scale run: scripts/accuracy_parity.py)."""
    train, test = synthetic_click_dataset(
        num_users=3000, num_items=5000, clicks_per_user=24, max_his=10,
        seed=5,
    )
    out = {}
    for mode in ("direct", "dedup"):
        cfg = CFConfig(
            emb_dim=32, num_negs=8, max_his=10, batch_size=4096,
            l_r=0.05, clip_val=1.0, seed=11, update_mode=mode,
            metrics=["Recall(k=20)"],
        )
        eng = Engine(cfg, train, test)
        losses = [eng.train_one_epoch() for _ in range(3)]
        assert losses[-1] < losses[0]
        out[mode] = eng.evaluate()["Recall(k=20)"]
    assert abs(out["direct"] - out["dedup"]) < 0.01, out


def test_headline_epoch_sanity():
    """One headline-config epoch at AmazonBooks geometry on the GPU
    (bf16 tables, tile sampler, direct atomic updates): finite decreasing
    loss, and epoch time far under the 245 s CPU reference baseline
    (BASELINE.md)."""
    rng = np.random.default_rng(0)
    U, I, N, H = 52_643, 91_599, 2_380_730, 100
    data = ClickDataset(
        pairs=np.stack(
            [rng.integers(0, U, N), rng.integers(0, I, N)], 1
        ).astype(np.int32),
        his_items=rng.integers(0, I, (U, H)).astype(np.int32),
        masks=np.full((U,), H, np.int32),
        num_users=U,
        num_items=I,
        max_his=H,
        user_items=[],
    )
    cfg = CFConfig(
        emb_dim=64, num_negs=16, max_his=H, batch_size=8192, l_r=0.01,
        clip_val=1.0, milestones=[10], seed=2022, his_refresh="subepoch",
        neg_sampler=1, tile_size=512, refresh_interval=8192,
        compute_dtype="bfloat16", param_dtype="bfloat16",
        update_mode="direct",
    )
    eng = Engine(cfg, data)
    l0 = eng.train_one_epoch()  # includes compile
    t0 = time.perf_counter()
    l1 = eng.train_one_epoch()
    dt = time.perf_counter() - t0
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0
    assert dt < 60.0, f"headline epoch took {dt:.1f}s"


@pytest.mark.deterministic
def test_emb_pad_identity_on_gpu():
    """emb_pad=128 (the huge-table row-width knob): on the GPU,
    padded-width tables must train to the same result as unpadded ones
    AND keep their tail columns exactly zero (any pad/real column leak —
    e.g. from a vectorized scatter touching the padded columns — lands
    here)."""
    train, test = synthetic_click_dataset(
        num_users=3000, num_items=5000, clicks_per_user=24, max_his=10,
        seed=5,
    )
    kw = dict(
        emb_dim=32, num_negs=8, max_his=10, batch_size=4096, l_r=0.05,
        clip_val=1.0, seed=11, metrics=["Recall(k=20)"],
    )
    e_base = Engine(CFConfig(**kw), train, test)
    e_pad = Engine(CFConfig(**kw, emb_pad=128), train, test)
    l_base = [e_base.train_one_epoch() for _ in range(2)]
    l_pad = [e_pad.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(l_pad, l_base, rtol=1e-5)
    ue = np.asarray(e_pad.state.user_emb, np.float32)
    ie = np.asarray(e_pad.state.item_emb, np.float32)
    assert ue.shape[1] == 128 and ie.shape[1] == 128
    assert not ue[:, 32:].any() and not ie[:, 32:].any()
    np.testing.assert_allclose(
        ue[:, :32], np.asarray(e_base.state.user_emb, np.float32),
        rtol=1e-4, atol=1e-7,
    )
    m_pad = e_pad.evaluate()
    m_base = e_base.evaluate()
    assert abs(m_pad["Recall(k=20)"] - m_base["Recall(k=20)"]) < 0.01


@pytest.mark.deterministic
def test_subepoch_fused_matches_per_bucket_on_gpu():
    """The one-dispatch sub-epoch program (tile sampler + partition
    complements + shape-static padded packing) must reproduce the
    per-bucket dispatch path on the GPU — the padded weight-0 batches,
    traced pool sizes, and remapped tile all exercise device layouts and
    atomic update order the CPU suite cannot."""
    train, test = synthetic_click_dataset(
        num_users=3000, num_items=5000, clicks_per_user=24, max_his=10,
        seed=7,
    )
    kw = dict(
        emb_dim=32, num_negs=8, max_his=10, batch_size=1024, l_r=0.05,
        clip_val=1.0, seed=3, num_subepochs=2, neg_sampler=1,
        tile_size=128, refresh_interval=2048,
    )
    e_fused = Engine(CFConfig(**kw), train, test, seed=5)
    fused = [e_fused.train_one_epoch() for _ in range(2)]
    e_seq = Engine(CFConfig(**kw), train, test, seed=5)
    e_seq._fuse_subepochs = False
    seq = [e_seq.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(fused, seq, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(e_fused.state.item_emb, np.float32),
        np.asarray(e_seq.state.item_emb, np.float32),
        rtol=1e-4, atol=1e-6,
    )
    np.testing.assert_array_equal(
        np.asarray(e_fused.sampler_state.tile),
        np.asarray(e_seq.sampler_state.tile),
    )


def test_serving_request_path_matches_recommend_all():
    """The serving request path (_topk_request: one (B, I) GEMM + packed
    per-row mask + masked_topk) must agree with the sliced whole-table
    ranking — the precision-sensitive (TF32) selection class. bf16 tables
    (trained regime) so score gaps often sit below bf16 ulp."""
    from heat_cf.serving import Recommender

    train, test = synthetic_click_dataset(
        num_users=3000, num_items=5000, clicks_per_user=24, max_his=10,
        seed=9,
    )
    cfg = CFConfig(
        emb_dim=32, num_negs=8, max_his=10, batch_size=4096, l_r=0.05,
        clip_val=1.0, seed=2, compute_dtype="bfloat16",
        param_dtype="bfloat16",
    )
    eng = Engine(cfg, train, test)
    for _ in range(2):
        eng.train_one_epoch()
    rec = Recommender(
        eng.state, cfg, seen_pairs=np.asarray(train.pairs),
        his_items=train.his_items, his_masks=train.masks,
    )
    rng = np.random.default_rng(0)
    uids = rng.choice(3000, 257, replace=False)  # off-pow2 batch
    ids_all = rec.recommend_all(10)[uids]
    ids_req = rec.recommend(uids, 10)
    if not np.array_equal(ids_req, ids_all):
        # Tie fallback: positions that differ must carry bit-equal
        # masked scores under an exact host ranking oracle.
        ue = np.asarray(eng.state.user_emb, np.float32)[uids]
        ie = np.asarray(eng.state.item_emb, np.float32)
        sim = ue.astype(np.float64) @ ie.astype(np.float64).T
        pairs = np.asarray(train.pairs)
        seen = {}
        for u, i in pairs:
            seen.setdefault(u, set()).add(i)
        for r, u in enumerate(uids):
            for i in seen.get(int(u), ()):
                sim[r, i] = -np.inf
        diff = ids_req != ids_all
        s_req = np.take_along_axis(sim, ids_req.astype(np.int64), 1)
        s_all = np.take_along_axis(sim, ids_all.astype(np.int64), 1)
        np.testing.assert_allclose(
            s_req[diff], s_all[diff], rtol=0, atol=0,
            err_msg="request path re-ranked non-tied scores",
        )


def test_chunked_and_filter_request_paths_on_gpu(monkeypatch):
    """DESIGN.md 6j: the huge-item-table request paths — the
    item-axis-chunked scan and the unmasked retrieve + host seen-filter
    — forced on at small scale via the module thresholds, on the GPU
    (the TF32 selection/merge class). All three representations must agree up to genuinely tied
    scores under a host f64 oracle."""
    import heat_cf.evaluation.evaluator as ev_mod
    import heat_cf.serving as serving

    train, test = synthetic_click_dataset(
        num_users=2000, num_items=6000, clicks_per_user=20, max_his=10,
        seed=4,
    )
    cfg = CFConfig(
        emb_dim=32, num_negs=8, max_his=10, batch_size=2048, l_r=0.05,
        seed=3,
    )
    eng = Engine(cfg, train, test)
    for _ in range(2):
        eng.train_one_epoch()
    rec_one = serving.Recommender(eng.state, cfg, seen_pairs=train.pairs)
    assert not rec_one._chunked_request
    monkeypatch.setattr(serving, "_CHUNKED_REQUEST_MIN_ITEMS", 1024)
    monkeypatch.setattr(serving, "_REQUEST_PAD_MULTIPLE", 2048)
    rec_chunk = serving.Recommender(eng.state, cfg, seen_pairs=train.pairs)
    assert rec_chunk._chunked_request and rec_chunk._bits_flat is not None
    monkeypatch.setattr(ev_mod, "MASK_BITS_MAX_BYTES", 16)
    rec_filt = serving.Recommender(eng.state, cfg, seen_pairs=train.pairs)
    assert rec_filt._bits_flat is None and rec_filt._seen_keys is not None

    rng = np.random.default_rng(0)
    uids = rng.choice(2000, 257, replace=False)  # 2*bpad=1024 < U
    outs = {
        "one": rec_one.recommend(uids, 10),
        "chunk": rec_chunk.recommend(uids, 10),
        "filt": rec_filt.recommend(uids, 10),
    }
    # Host f64 oracle for tie-aware comparison (same pattern as
    # test_serving_request_path_matches_recommend_all).
    ue = np.asarray(eng.state.user_emb, np.float32)[uids]
    ie = np.asarray(eng.state.item_emb, np.float32)
    sim = ue.astype(np.float64) @ ie.astype(np.float64).T
    seen = {}
    for u, i in np.asarray(train.pairs):
        seen.setdefault(int(u), set()).add(int(i))
    for r, u in enumerate(uids):
        for i in seen.get(int(u), ()):
            sim[r, i] = -np.inf
    ref = outs["one"]
    s_ref = np.take_along_axis(sim, ref.astype(np.int64), 1)
    for name in ("chunk", "filt"):
        got = outs[name]
        for row, gu in zip(got, uids):
            for item in row:
                assert int(item) not in seen.get(int(gu), set()), name
        diff = got != ref
        s_got = np.take_along_axis(sim, got.astype(np.int64), 1)
        np.testing.assert_allclose(
            s_got[diff], s_ref[diff], rtol=0, atol=0,
            err_msg=f"{name} path re-ranked non-tied scores",
        )


def test_large_batch_auto_tile_epoch_sanity():
    """The large-batch config (batch 32768, Alg-1 auto tile -> 128,
    refresh 32768) on the GPU: finite decreasing loss and the
    auto-derived tile geometry actually in effect."""
    rng = np.random.default_rng(0)
    U, I, N, H = 52_643, 91_599, 2_380_730, 100
    data = ClickDataset(
        pairs=np.stack(
            [rng.integers(0, U, N), rng.integers(0, I, N)], 1
        ).astype(np.int32),
        his_items=rng.integers(0, I, (U, H)).astype(np.int32),
        masks=np.full((U,), H, np.int32),
        num_users=U,
        num_items=I,
        max_his=H,
        user_items=[],
    )
    cfg = CFConfig(
        emb_dim=64, num_negs=16, max_his=H, batch_size=32768, l_r=0.04,
        clip_val=1.0, milestones=[10], seed=2022, his_refresh="subepoch",
        neg_sampler=1, tile_size=0, refresh_interval=32768,
        compute_dtype="bfloat16", param_dtype="bfloat16",
        update_mode="direct",
    )
    eng = Engine(cfg, data)
    assert eng.cfg.tile_size == 128, eng.cfg.tile_size  # Alg-1 at 32k
    l0 = eng.train_one_epoch()
    t0 = time.perf_counter()
    l1 = eng.train_one_epoch()
    dt = time.perf_counter() - t0
    assert np.isfinite(l0) and np.isfinite(l1) and l1 < l0
    assert dt < 60.0, f"32k auto-tile epoch took {dt:.1f}s"


@pytest.mark.deterministic
def test_fused_full_run_matches_unfused_on_gpu():
    """The fused train->eval run program (train/run.py) inlines the tiled
    bitmask top-k and on-device metric reduction INSIDE a donated
    multi-epoch program — device layout/TF32 hazards the CPU
    equivalence test cannot see. Losses and metric values must match the
    unfused shape."""
    train, test = synthetic_click_dataset(
        num_users=3000, num_items=5000, clicks_per_user=24, max_his=10,
        seed=13,
    )
    kw = dict(
        emb_dim=32, num_negs=8, max_his=10, batch_size=4096, l_r=0.05,
        clip_val=1.0, seed=4, metrics=["Recall(k=20)", "NDCG(k=20)"],
    )
    e_fused = Engine(CFConfig(**kw), train, test)
    losses_f, evals_f = e_fused.run_epochs_with_eval(3, 2)
    e_seq = Engine(CFConfig(**kw), train, test)
    losses_s, evals_s = e_seq.run_epochs_with_eval(3, 2, fused=False)
    np.testing.assert_allclose(losses_f, losses_s, rtol=1e-5)
    assert [e["epoch"] for e in evals_f] == [e["epoch"] for e in evals_s]
    for ef, es in zip(evals_f, evals_s):
        for m in kw["metrics"]:
            np.testing.assert_allclose(ef[m], es[m], rtol=1e-5, atol=1e-6)


@pytest.mark.deterministic
def test_fused_full_run_subepoch_matches_unfused_on_gpu():
    """The fused full-run program over the on-device-bucketed
    sub-epoch epoch (train/run.make_run_fn_subepoch — the reference's
    DEFAULT shape: tile sampler + num_subepoches, cf_config.py:7, with
    interleaved evals) must match the unfused fallback on the GPU: the
    device-side stable partition sort, dynamic bucket windows, padded
    weight-0 batches, and the inlined bitmask top-k all exercise device
    layout/TF32 paths the CPU equivalence test cannot."""
    train, test = synthetic_click_dataset(
        num_users=3000, num_items=5000, clicks_per_user=24, max_his=10,
        seed=17,
    )
    kw = dict(
        emb_dim=32, num_negs=8, max_his=10, batch_size=1024, l_r=0.05,
        clip_val=1.0, seed=6, num_subepochs=2, neg_sampler=1,
        tile_size=128, refresh_interval=2048,
        metrics=["Recall(k=20)", "NDCG(k=20)"],
    )
    e_fused = Engine(CFConfig(**kw), train, test, seed=5)
    losses_f, evals_f = e_fused.run_epochs_with_eval(3, 2)
    assert getattr(e_fused, "_run_fn_subep_cache", None) is not None
    e_seq = Engine(CFConfig(**kw), train, test, seed=5)
    losses_s, evals_s = e_seq.run_epochs_with_eval(3, 2, fused=False)
    np.testing.assert_allclose(losses_f, losses_s, rtol=1e-5)
    assert [e["epoch"] for e in evals_f] == [e["epoch"] for e in evals_s]
    for ef, es in zip(evals_f, evals_s):
        for m in kw["metrics"]:
            np.testing.assert_allclose(ef[m], es[m], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(e_fused.state.item_emb, np.float32),
        np.asarray(e_seq.state.item_emb, np.float32),
        rtol=1e-4, atol=1e-6,
    )


def test_exact_topk_recursive_branch_on_gpu():
    """exact_topk_2phase's RECURSIVE window path (engaged only above
    _TOPK_2PHASE_MIN_ITEMS * _TOPK_WINDOW = 524,288 items — the branch
    bench_large.py's 6M-item eval takes) against a host oracle on the
    GPU. Scores are per-row permutations of arange(n): all distinct and
    exactly representable in f32, so the expected ranking is unambiguous;
    a TF32 extraction matmul would round scores above 2^11 and fail it."""
    from heat_cf.evaluation.evaluator import (
        _TOPK_2PHASE_MIN_ITEMS,
        _TOPK_WINDOW,
        exact_topk_2phase,
    )

    n = 600_000
    assert n >= _TOPK_2PHASE_MIN_ITEMS * _TOPK_WINDOW  # recursion engaged
    rng = np.random.default_rng(2)
    B, K = 4, 50
    sim_np = np.stack(
        [rng.permutation(n).astype(np.float32) for _ in range(B)]
    )
    scores, ids = jax.jit(lambda s: exact_topk_2phase(s, K))(
        jnp.asarray(sim_np)
    )
    scores, ids = np.asarray(scores), np.asarray(ids)
    want_ids = np.argsort(-sim_np, axis=1, kind="stable")[:, :K]
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(
        scores, np.take_along_axis(sim_np, want_ids, 1)
    )


@pytest.mark.deterministic
def test_attention_dedup_grouped_stream_on_gpu():
    """The attention history-gather dedup (the accl_self_grouped_s bench
    row's path) on the GPU — dedup-on and dedup-off engines agree on the
    loss trajectory and ranking on a user-grouped fixed stream, for both
    attention variants. Guards the uniq gather/pool/inverse-gather
    composition against device layout/TF32 drift (the CPU equivalence
    test cannot see device layouts)."""
    train, test = synthetic_click_dataset(
        num_users=2000, num_items=4000, clicks_per_user=24, max_his=10,
        seed=21,
    )
    for agg, extra in (
        ("self_attention", dict(update_mode="direct")),
        ("user_attention", dict()),  # dedup-eligible: combine-then-clip
    ):
        kw = dict(
            emb_dim=32, num_negs=8, max_his=10, batch_size=1024,
            l_r=0.05, clip_val=1.0, seed=6, shuffle_mode="none",
            his_refresh="step", aggregator=agg, neg_sampler=1,
            tile_size=128, refresh_interval=2048,
            compute_dtype="bfloat16", param_dtype="bfloat16", **extra,
        )
        e_on = Engine(CFConfig(**kw), train, test, seed=5)
        on = [e_on.train_one_epoch() for _ in range(2)]
        assert e_on._dedup_cache[1] is not None, (agg, "dedup idle")
        e_off = Engine(CFConfig(**kw), train, test, seed=5)
        e_off._history_dedup = lambda pairs, users: None
        off = [e_off.train_one_epoch() for _ in range(2)]
        # bf16 + attention chaos: loss drift is ~1e-4..6e-4-rel on CPU
        # and up to ~1.3e-3-rel on the H100 (deterministic ops); the
        # guarded failure mode (layout/clamp shear) is orders-of-magnitude
        # grosser.
        np.testing.assert_allclose(on, off, rtol=5e-3)
        m_on = e_on.evaluate(["Recall(k=20)"])["Recall(k=20)"]
        m_off = e_off.evaluate(["Recall(k=20)"])["Recall(k=20)"]
        assert abs(m_on - m_off) < 0.05, (agg, m_on, m_off)
