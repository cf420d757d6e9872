"""Both row-update implementations (dense-accumulator and sort-dedup) must
implement identical semantics — duplicates summed then clipped, padding
dropped, accum decay on touched rows only."""

import jax.numpy as jnp
import numpy as np
import pytest

from heat_cf.train.scatter import (
    _apply_row_updates_dense,
    _apply_row_updates_sorted,
    segment_sum_by_id,
)


def _random_case(seed, rows=50, d=8, m=64, with_pad=True):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, d)).astype(np.float32)
    ids = rng.integers(0, rows, m).astype(np.int32)
    if with_pad:
        ids[m // 2 :] = np.where(
            rng.random(m - m // 2) < 0.3, rows, ids[m // 2 :]
        )  # some drop sentinels
    grads = rng.normal(size=(m, d)).astype(np.float32) * 0.3
    gacc = rng.normal(size=(rows, d)).astype(np.float32) * 0.1
    return table, ids, grads, gacc


def test_segment_sum_by_id():
    ids = jnp.asarray([3, 1, 3, 7, 1], jnp.int32)
    vals = jnp.asarray([[1.0], [2.0], [10.0], [4.0], [20.0]])
    rep, summed = segment_sum_by_id(ids, vals, 10)
    out = np.zeros((10, 1))
    r, s = np.asarray(rep), np.asarray(summed)
    for i in range(len(r)):
        if r[i] < 10:
            out[r[i]] += s[i]
    np.testing.assert_allclose(out[1], [22.0])
    np.testing.assert_allclose(out[3], [11.0])
    np.testing.assert_allclose(out[7], [4.0])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("accum", [False, True])
@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_dense_and_sorted_paths_agree(seed, accum, l2):
    table, ids, grads, gacc = _random_case(seed)
    kwargs = dict(
        lr=jnp.float32(0.1),
        clip_val=0.25,  # binds often -> exercises clip-after-sum semantics
        gacc=jnp.asarray(gacc) if accum else None,
        decay=0.4,
        l2=l2,
    )
    td, gd = _apply_row_updates_dense(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads), **kwargs
    )
    kwargs["gacc"] = jnp.asarray(gacc) if accum else None
    ts, gs = _apply_row_updates_sorted(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads), **kwargs
    )
    np.testing.assert_allclose(np.asarray(td), np.asarray(ts), rtol=2e-5, atol=1e-6)
    if accum:
        np.testing.assert_allclose(
            np.asarray(gd), np.asarray(gs), rtol=2e-5, atol=1e-6
        )


def test_padding_ids_dropped():
    table, ids, grads, _ = _random_case(5, with_pad=False)
    rows = table.shape[0]
    all_pad = np.full_like(ids, rows)
    td, _ = _apply_row_updates_dense(
        jnp.asarray(table),
        jnp.asarray(all_pad),
        jnp.asarray(grads),
        lr=jnp.float32(0.1),
        clip_val=1.0,
        gacc=None,
        decay=1.0,
        l2=0.0,
    )
    np.testing.assert_array_equal(np.asarray(td), table)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_fused_writeback_matches_set_then_update(seed, l2):
    """writeback= fuses the aggregated-row set into the update's scatter
    (one row scatter on huge tables); must equal set-then-update exactly.
    Duplicate ids carry IDENTICAL writeback rows (in batch mode u_agg is a
    function of the id and the pre-batch state), so the fusion's
    first-occurrence pick is not even observable."""
    table, ids, grads, _ = _random_case(seed)  # has duplicates + padding
    rng = np.random.default_rng(seed + 100)
    # identical writeback row per unique id
    per_id = rng.normal(size=(table.shape[0] + 1, table.shape[1])).astype(
        np.float32
    )
    wb = jnp.asarray(per_id[np.minimum(ids, table.shape[0])])
    kwargs = dict(lr=jnp.float32(0.1), clip_val=0.25, decay=1.0, l2=l2)

    t_ref = jnp.asarray(table).at[jnp.asarray(ids)].set(wb, mode="drop")
    t_ref, _ = _apply_row_updates_sorted(
        t_ref, jnp.asarray(ids), jnp.asarray(grads), gacc=None, **kwargs
    )
    t_fused, _ = _apply_row_updates_sorted(
        jnp.asarray(table),
        jnp.asarray(ids),
        jnp.asarray(grads),
        gacc=None,
        writeback=wb,
        **kwargs,
    )
    np.testing.assert_allclose(
        np.asarray(t_ref), np.asarray(t_fused), rtol=1e-6, atol=1e-7
    )


@pytest.mark.parametrize("adam", [False, True])
def test_fused_writeback_opt_matches_set_then_update(adam):
    from heat_cf.train.scatter import _apply_row_updates_opt_sorted

    table, ids, grads, _ = _random_case(7)
    rng = np.random.default_rng(11)
    per_id = rng.normal(size=(table.shape[0] + 1, table.shape[1])).astype(
        np.float32
    )
    wb = jnp.asarray(per_id[np.minimum(ids, table.shape[0])])
    v = jnp.asarray(
        rng.uniform(0.0, 0.1, size=table.shape).astype(np.float32)
    )
    m = (
        jnp.asarray(rng.normal(0, 0.01, size=table.shape).astype(np.float32))
        if adam
        else None
    )
    kwargs = dict(
        lr=jnp.float32(0.1), clip_val=0.25, step=jnp.asarray(3, jnp.int32),
        beta1=0.9, beta2=0.999, eps=1e-8, l2=0.01,
    )
    t_ref = jnp.asarray(table).at[jnp.asarray(ids)].set(wb, mode="drop")
    t_ref, m_ref, v_ref = _apply_row_updates_opt_sorted(
        t_ref, jnp.asarray(ids), jnp.asarray(grads), m=m, v=v, **kwargs
    )
    t_fused, m_fused, v_fused = _apply_row_updates_opt_sorted(
        jnp.asarray(table),
        jnp.asarray(ids),
        jnp.asarray(grads),
        m=m,
        v=v,
        writeback=wb,
        **kwargs,
    )
    np.testing.assert_allclose(
        np.asarray(t_ref), np.asarray(t_fused), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(v_ref), np.asarray(v_fused), rtol=1e-6, atol=1e-7
    )
    if adam:
        np.testing.assert_allclose(
            np.asarray(m_ref), np.asarray(m_fused), rtol=1e-6, atol=1e-7
        )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_direct_matches_dedup_when_clip_unbound(seed, l2):
    """update_mode='direct' (per-occurrence scatter-add of -lr*clip(g))
    equals the dedup path whenever the clip never binds: sum-then-clip ==
    clip-then-sum for unclipped rows, and in f32 the only difference is
    fp associativity. l2 parity needs matching row operands: the dedup
    path reads the post-write-back table row, so direct gets rows=wb.
    l2 itself is applied per occurrence in direct mode (vs once per
    touched row), so the l2 case uses duplicate-free ids."""
    from heat_cf.train.scatter import apply_row_updates_direct

    table, ids, grads, _ = _random_case(seed)  # duplicates + padding
    if l2:
        rng0 = np.random.default_rng(seed)
        ids = rng0.permutation(table.shape[0] + 1).astype(np.int32)
        grads = grads[: ids.shape[0]]  # unique ids (incl. the sentinel)
    rng = np.random.default_rng(seed + 200)
    per_id = rng.normal(size=(table.shape[0] + 1, table.shape[1])).astype(
        np.float32
    )
    wb = jnp.asarray(per_id[np.minimum(ids, table.shape[0])])
    kwargs = dict(lr=jnp.float32(0.1), clip_val=1e9, l2=l2)

    t_ref = jnp.asarray(table).at[jnp.asarray(ids)].set(wb, mode="drop")
    t_ref, _ = _apply_row_updates_dense(
        t_ref, jnp.asarray(ids), jnp.asarray(grads),
        gacc=None, decay=1.0, **kwargs,
    )
    t_direct = apply_row_updates_direct(
        jnp.asarray(table),
        jnp.asarray(ids),
        jnp.asarray(grads),
        rows=wb if l2 else None,
        writeback=wb,
        **kwargs,
    )
    np.testing.assert_allclose(
        np.asarray(t_ref), np.asarray(t_direct), rtol=2e-5, atol=1e-6
    )


def test_direct_clips_per_occurrence():
    """Where the clip binds, direct caps each occurrence: two +1.0 grads
    on one row under clip 0.5 move it by 2*lr*0.5 (dedup: lr*0.5... no —
    dedup clips the SUM at 1.0->0.5; direct clips each at 0.5 then sums
    to 1.0)."""
    from heat_cf.train.scatter import apply_row_updates_direct

    table = jnp.zeros((4, 2), jnp.float32)
    ids = jnp.asarray([1, 1], jnp.int32)
    grads = jnp.ones((2, 2), jnp.float32)
    out = apply_row_updates_direct(
        table, ids, grads, lr=jnp.float32(0.1), clip_val=0.5
    )
    np.testing.assert_allclose(np.asarray(out[1]), [-0.1, -0.1], rtol=1e-6)
