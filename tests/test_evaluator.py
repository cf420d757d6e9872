"""Tiled on-device evaluator vs dense numpy oracle."""

import jax
import numpy as np

from heat_cf.evaluation.evaluator import (
    TiledEvaluator,
    full_sim_matrix,
    topk_scores,
)


def _dense_topk(user_emb, item_emb, pairs, k):
    sim = user_emb @ item_emb.T
    for u, i in pairs:
        sim[u, i] = -np.inf
    ids = np.argsort(-sim, axis=1, kind="stable")[:, :k]
    scores = np.take_along_axis(sim, ids, axis=1)
    return scores, ids


def test_topk_matches_dense_with_masking():
    rng = np.random.default_rng(0)
    u_n, i_n, d, k = 300, 257, 16, 10
    user_emb = rng.normal(size=(u_n, d)).astype(np.float32)
    item_emb = rng.normal(size=(i_n, d)).astype(np.float32)
    pairs = np.stack(
        [rng.integers(0, u_n, 500), rng.integers(0, i_n, 500)], axis=1
    ).astype(np.int32)
    pairs = np.unique(pairs, axis=0)

    scores, ids = topk_scores(
        user_emb, item_emb, k, train_pairs=pairs, user_tile=64
    )
    want_scores, _ = _dense_topk(user_emb.copy(), item_emb, pairs, k)
    # Compare by scores (tie order between equal scores may differ).
    np.testing.assert_allclose(scores, want_scores, rtol=1e-4, atol=1e-5)
    # Masked items never appear.
    masked = {(int(u), int(i)) for u, i in pairs}
    for u in range(u_n):
        for i in ids[u]:
            assert (u, int(i)) not in masked


def test_topk_no_mask():
    rng = np.random.default_rng(1)
    user_emb = rng.normal(size=(10, 4)).astype(np.float32)
    item_emb = rng.normal(size=(20, 4)).astype(np.float32)
    scores, ids = topk_scores(user_emb, item_emb, 5, user_tile=4)
    sim = user_emb @ item_emb.T
    want = np.sort(-sim, axis=1)
    np.testing.assert_allclose(scores, -want[:, :5], rtol=1e-5)


def test_full_sim_matrix():
    rng = np.random.default_rng(2)
    u = rng.normal(size=(5, 3)).astype(np.float32)
    i = rng.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(full_sim_matrix(u, i), u @ i.T, rtol=1e-5)


def test_exact_topk_2phase_matches_lax_topk():
    """Window-max pre-selection must reproduce lax.top_k exactly
    (unique random scores), across widths incl. non-multiples of 128."""
    import jax
    import jax.numpy as jnp

    from heat_cf.evaluation.evaluator import exact_topk_2phase

    rng = np.random.default_rng(0)
    for b, n, k in [(7, 5000, 50), (3, 4096, 10), (5, 9973, 64), (2, 300, 20)]:
        sim = jnp.asarray(
            rng.permutation(n * b).reshape(b, n).astype(np.float32)
        )
        s_ref, i_ref = jax.lax.top_k(sim, k)
        s_2p, i_2p = exact_topk_2phase(sim, k)
        np.testing.assert_array_equal(np.asarray(i_ref), np.asarray(i_2p))
        np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_2p))


def test_exact_topk_2phase_with_masked_rows():
    import jax
    import jax.numpy as jnp

    from heat_cf.evaluation.evaluator import NEG_INF, exact_topk_2phase

    rng = np.random.default_rng(1)
    sim = rng.normal(size=(4, 6000)).astype(np.float32)
    # mask most entries of one row, all of another
    sim[1, 200:] = NEG_INF
    sim[2, :] = NEG_INF
    sim = jnp.asarray(sim)
    s_ref, i_ref = jax.lax.top_k(sim, 30)
    s_2p, i_2p = exact_topk_2phase(sim, 30)
    np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_2p))
    # id agreement wherever scores are finite (ties among -inf entries
    # may resolve differently; scores already pinned equal above)
    finite = np.asarray(s_ref) > NEG_INF / 2
    np.testing.assert_array_equal(
        np.asarray(i_ref)[finite], np.asarray(i_2p)[finite]
    )


def test_tiled_evaluator_2phase_scale_matches_numpy():
    """At >=4096 items the evaluator routes exact top-k through the
    two-phase path; pin it against a numpy argsort oracle."""
    rng = np.random.default_rng(3)
    u, i, k = 130, 4608, 25
    user = rng.normal(size=(u, 16)).astype(np.float32)
    item = rng.normal(size=(i, 16)).astype(np.float32)
    pairs = np.stack(
        [rng.integers(0, u, 500), rng.integers(0, i, 500)], 1
    ).astype(np.int32)
    ev = TiledEvaluator(pairs, u, user_tile=64, num_items=i)
    _, ids = ev.topk(user, item, k)
    sim = user @ item.T
    sim[pairs[:, 0], pairs[:, 1]] = -np.inf
    ref = np.argsort(-sim, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ids, ref)


def test_exact_topk_2phase_recursive_wide():
    """At >=4096 windows the window-max top-k recurses; exactness must
    hold through the recursion (524k-wide rows -> 4096 windows)."""
    import jax
    import jax.numpy as jnp

    from heat_cf.evaluation.evaluator import exact_topk_2phase

    rng = np.random.default_rng(5)
    n = 524_288  # 4096 windows of 128
    sim = jnp.asarray(rng.permutation(n).reshape(1, n).astype(np.float32))
    sim = jnp.concatenate([sim, sim[:, ::-1]], axis=0)
    s_ref, i_ref = jax.lax.top_k(sim, 17)
    s_2p, i_2p = exact_topk_2phase(sim, 17)
    np.testing.assert_array_equal(np.asarray(i_ref), np.asarray(i_2p))
    np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_2p))


def test_exact_topk_2phase_extraction_precision_pinned():
    """Regression guard for an accelerator-only inexactness: the
    candidate extraction one-hot matmul must run at HIGHEST precision. At
    default precision a GPU runs f32 matmuls in TF32, which rounds the
    extracted scores and re-ranks candidates that differ below TF32
    resolution. CPU matmuls are exact f32, so only the lowering can be
    pinned here."""
    import jax
    import jax.numpy as jnp

    from heat_cf.evaluation.evaluator import exact_topk_2phase

    txt = jax.jit(lambda s: exact_topk_2phase(s, 10)).lower(
        jnp.zeros((2, 8192), jnp.float32)
    ).as_text()
    assert "precision = [HIGHEST, HIGHEST]" in txt


def test_topk_all_tiles_gemm_precision_pinned():
    """The sim GEMM and the extraction matmul inside the tiled evaluator
    must both carry HIGHEST precision (f32-table eval would otherwise
    score at TF32 fidelity on a GPU, unlike the reference's f32 GEMM)."""
    import re

    import jax
    import numpy as np

    from heat_cf.evaluation.evaluator import TiledEvaluator

    rng = np.random.default_rng(0)
    pairs = np.stack(
        [rng.integers(0, 64, 100), rng.integers(0, 8192, 100)], 1
    ).astype(np.int32)
    ev = TiledEvaluator(pairs, 64, user_tile=32, num_items=8192)
    user = rng.normal(size=(64, 16)).astype(np.float32)
    item = rng.normal(size=(8192, 16)).astype(np.float32)
    # Trigger one topk call, then inspect the cached jitted lowering.
    ev.topk(user, item, 10)
    from heat_cf.evaluation import evaluator as EV

    txt = jax.jit(
        lambda u, i: EV.exact_topk_2phase(u @ i.T, 10),
    ).lower(
        jax.numpy.zeros((32, 16), jax.numpy.float32),
        jax.numpy.zeros((8192, 16), jax.numpy.float32),
    ).as_text()
    # the 2phase extraction inside is HIGHEST; the plain u @ i.T here is
    # whatever the caller asked — the evaluator's own GEMM is pinned at
    # the source (evaluator.py _topk_all_tiles body).
    assert len(re.findall(r"precision = \[HIGHEST, HIGHEST\]", txt)) >= 1


def test_sharded_topk_matches_tiled_evaluator():
    """The shard_map distributed top-k (per-shard score+mask+topk, one
    k*n_model candidate all_gather, exact merge) must reproduce the
    single-device TiledEvaluator exactly — scores always; ids up to ties."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from heat_cf.evaluation.evaluator import (
        pack_train_bits,
        sharded_topk,
        sharded_topk_supported,
    )
    from heat_cf.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh

    rng = np.random.default_rng(0)
    U, I, d, k = 64, 256, 16, 10
    mesh = make_mesh(2, 4, jax.devices()[:8])
    assert sharded_topk_supported(mesh, I, k, U)
    ue = rng.normal(0, 1, (U, d)).astype(np.float32)
    ie = rng.normal(0, 1, (I, d)).astype(np.float32)
    pairs = np.stack(
        [rng.integers(0, U, 500), rng.integers(0, I, 500)], 1
    ).astype(np.int32)
    bits = pack_train_bits(pairs, U, I)
    u_sh = jax.device_put(
        jax.numpy.asarray(ue), NamedSharding(mesh, P(DATA_AXIS, None))
    )
    i_sh = jax.device_put(
        jax.numpy.asarray(ie), NamedSharding(mesh, P(MODEL_AXIS, None))
    )
    b_sh = jax.device_put(
        jax.numpy.asarray(bits), NamedSharding(mesh, P(DATA_AXIS, None))
    )
    s, ids = sharded_topk(mesh, u_sh, i_sh, b_sh, k, user_chunk=16)
    ev = TiledEvaluator(pairs, U, num_items=I)
    ref_s, ref_ids = ev.topk(ue, ie, k, return_scores=True)
    np.testing.assert_allclose(np.asarray(s), ref_s, rtol=1e-5)
    # Ids agree through scores (tie order may differ between mergers).
    sim = ue @ ie.T
    np.testing.assert_allclose(
        np.take_along_axis(sim, np.asarray(ids), 1), ref_s, rtol=1e-5
    )
    # Masked train pairs never appear in the results.
    mask_set = {(int(a), int(b)) for a, b in pairs}
    got = np.asarray(ids)
    hits = sum(
        1 for u in range(U) for j in range(k) if (u, int(got[u, j])) in mask_set
    )
    assert hits == 0


def test_sharded_topk_odd_items_padded():
    """ANY item count must take the shard_map path after item-axis padding
    (AmazonBooks' 91,599 items previously fell back to
    the O(I*d)-per-host allgather). An odd I, padded via sharded_pad_items
    (zero rows + pad bits), must reproduce the single-device evaluator."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from heat_cf.evaluation.evaluator import (
        pack_train_bits,
        sharded_pad_items,
        sharded_topk,
        sharded_topk_supported,
    )
    from heat_cf.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh

    rng = np.random.default_rng(3)
    U, I, d, k = 64, 251, 16, 10  # 251: prime, not lane- or word-aligned
    mesh = make_mesh(2, 4, jax.devices()[:8])
    assert sharded_topk_supported(mesh, I, k, U)
    pad_items = sharded_pad_items(mesh, I)
    assert pad_items % (128 * 4) == 0 and pad_items >= I
    ue = rng.normal(0, 1, (U, d)).astype(np.float32)
    ie = rng.normal(0, 1, (I, d)).astype(np.float32)
    pairs = np.stack(
        [rng.integers(0, U, 400), rng.integers(0, I, 400)], 1
    ).astype(np.int32)
    bits = pack_train_bits(pairs, U, I, pad_items=pad_items)
    ie_pad = np.concatenate(
        [ie, np.zeros((pad_items - I, d), np.float32)]
    )
    u_sh = jax.device_put(
        jax.numpy.asarray(ue), NamedSharding(mesh, P(DATA_AXIS, None))
    )
    i_sh = jax.device_put(
        jax.numpy.asarray(ie_pad), NamedSharding(mesh, P(MODEL_AXIS, None))
    )
    b_sh = jax.device_put(
        jax.numpy.asarray(bits), NamedSharding(mesh, P(DATA_AXIS, None))
    )
    s, ids = sharded_topk(mesh, u_sh, i_sh, b_sh, k, user_chunk=16)
    ev = TiledEvaluator(pairs, U, num_items=I)
    ref_s, ref_ids = ev.topk(ue, ie, k, return_scores=True)
    np.testing.assert_allclose(np.asarray(s), ref_s, rtol=1e-5)
    got = np.asarray(ids)
    # No pad item (id >= I) can ever surface.
    assert got.max() < I
    # Ids agree through scores (tie order between mergers may differ).
    sim = ue @ ie.T
    np.testing.assert_allclose(
        np.take_along_axis(sim, got, 1), ref_s, rtol=1e-5
    )


def test_device_metric_sums_combines():
    """device_metric_sums is the exact combinable form: sums/count equals
    evaluate_metrics_device on the same inputs."""
    from heat_cf.evaluation.metrics import (
        device_metric_sums,
        evaluate_metrics_device,
        pad_truth,
    )

    rng = np.random.default_rng(1)
    U, k = 40, 10
    top = rng.integers(0, 100, (U, k)).astype(np.int32)
    truth_lists = [
        rng.integers(0, 100, rng.integers(0, 6)).astype(np.int32)
        for _ in range(U)
    ]
    truth, tlen = pad_truth(truth_lists)
    metrics = ["Recall(k=10)", "NDCG(k=5)", "MRR(k=10)"]
    sums = device_metric_sums(metrics, top, truth, tlen)
    ref = evaluate_metrics_device(metrics, top, truth, tlen)
    denom = max(sums[-1], 1.0)
    for i, m in enumerate(metrics):
        np.testing.assert_allclose(sums[i] / denom, ref[m], rtol=1e-6)
