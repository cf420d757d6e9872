"""Duplicate-safe sparse row updates for embedding tables.

The reference applies per-sample SGD row updates sequentially, so duplicate
ids within a stream are handled by read-modify-write ordering
(matrix_factorization.cpp:127-150, 166-174). A vectorized batch must instead
combine gradients per *unique* row before clipping and applying the update
(SURVEY.md section 7 "Hard parts": duplicate ids in a batch).

Two implementations, selected by table size:

* dense-accumulator (default for tables up to DENSE_ROWS_THRESHOLD rows):
  scatter-add all occurrence gradients into a zeroed table-shaped
  accumulator (duplicates combine natively), then apply one dense
  elementwise update — untouched rows see clip(0) == 0 and are unchanged.
  No sorting (the faster of the two at AmazonBooks scale on the previous
  accelerator; not re-measured on the GPU yet).
* sort-dedup (for huge tables, e.g. the 100M-row synthetic config, where
  an O(num_rows) dense pass per step is unacceptable): sort ids, segment-sum
  runs of equal ids, and scatter the combined update through one
  representative index per run. Out-of-range representative slots (padding)
  are dropped by JAX scatter semantics (mode="drop").

Both are shape-static, jit-friendly, and clip the *combined* per-row
gradient (the reference clips the accumulated row, optimizer.cpp:17-22).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def segment_sum_by_id(
    ids: jnp.ndarray, values: jnp.ndarray, num_rows: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Combine rows of ``values`` that share an id.

    Args:
      ids: (M,) int32 row ids; ids == num_rows mark padding to drop.
      values: (M, d) per-occurrence values.
      num_rows: table size (used as the drop sentinel).

    Returns:
      (rep_ids, summed): both length M. ``summed[s]`` is the total value for
      unique id ``rep_ids[s]``; unused trailing segments have rep_ids ==
      num_rows (dropped on scatter) and summed == 0.
    """
    m = ids.shape[0]
    order = jnp.argsort(ids)
    sid = ids[order]
    sval = values[order]
    starts = jnp.concatenate(
        [jnp.ones((1,), dtype=bool), sid[1:] != sid[:-1]]
    )
    seg = jnp.cumsum(starts) - 1  # (M,) segment index per occurrence
    summed = jax.ops.segment_sum(sval, seg, num_segments=m)
    rep_ids = jnp.full((m,), num_rows, dtype=ids.dtype).at[seg].set(sid)
    return rep_ids, summed


# Tables at or below this row count use the dense-accumulator path; above
# it, the sort-dedup path (dense cost is O(rows * dim) per step).
DENSE_ROWS_THRESHOLD = 4 * 1024 * 1024


@jax.named_scope("write_emb")
def apply_row_updates(
    table: jnp.ndarray,
    ids: jnp.ndarray,
    grads: jnp.ndarray,
    *,
    lr: jnp.ndarray,
    clip_val: float,
    gacc: Optional[jnp.ndarray] = None,
    decay: float = 1.0,
    l2: float = 0.0,
    writeback: Optional[jnp.ndarray] = None,
) -> tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """SGD row update with elementwise clip and optional accumulation.

    Batch mode (gacc is None):
        g = clip(sum_per_unique(grads) [+ l2 * row])
        row -= lr * g
    Accum mode (reference semantics, sgd.cpp:14-26 on persistent grad rows):
        acc_new = clip(decay * acc + sum_per_unique(grads))
        row -= lr * acc_new;  acc stored clipped (optimizer.cpp:17-22 writes
        the clipped value back into the gradient row).
    ``decay`` is gamma for the user table — the reference aggregator backward
    rescales the whole accumulated user-grad row by gamma on every visit
    (behavior_aggregators.cpp:148-152); 1.0 for item tables.

    writeback: optional (M, d) replacement rows conceptually written to
    ``table[ids]`` BEFORE the update (the user table's aggregated-embedding
    write-back, matrix_factorization.cpp:166-174). On the sorted (huge-
    table) path the write-back and the update fuse into ONE row scatter —
    the scatter is the dominant per-step cost there. For a duplicated id the surviving write-back
    row is the first occurrence in sorted order (the separate-set version's
    winner is whichever duplicate XLA picks; both are valid under the
    batch-mode semantics, where every occurrence reads the same pre-batch
    row). Batch mode only (gacc must be None).

    ids == table.shape[0] are padding and are dropped.
    """
    # The dense path is taken for every table up to the threshold, even
    # at ~10% touched-id density (tile path: 8.7k ids on the 91.6k-row
    # item table), where the sort + per-row scatter cost more than the
    # dense passes on the previous accelerator. The sort path is for huge
    # tables only, where an O(rows) pass per step is unacceptable. The
    # crossover is not re-derived on the GPU yet (ROADMAP).
    if writeback is not None and gacc is not None:
        raise ValueError("writeback fusion is batch-mode only (gacc=None)")
    if table.shape[0] <= DENSE_ROWS_THRESHOLD:
        if writeback is not None:
            # Dense path: the write-back stays a separate scatter (the
            # dense full-table pass dominates there, not the scatter).
            table = table.at[ids].set(
                writeback.astype(table.dtype), mode="drop"
            )
        return _apply_row_updates_dense(
            table, ids, grads, lr=lr, clip_val=clip_val, gacc=gacc,
            decay=decay, l2=l2,
        )
    return _apply_row_updates_sorted(
        table, ids, grads, lr=lr, clip_val=clip_val, gacc=gacc,
        decay=decay, l2=l2, writeback=writeback,
    )


@jax.named_scope("write_emb")
def apply_row_updates_direct(
    table: jnp.ndarray,
    ids: jnp.ndarray,
    grads: jnp.ndarray,
    *,
    lr: jnp.ndarray,
    clip_val: float,
    l2: float = 0.0,
    rows: Optional[jnp.ndarray] = None,
    writeback: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Per-occurrence SGD: one scatter-add of ``-lr * clip(g)`` increments.

    ``cfg.update_mode == "direct"``: no f32 accumulator, no touched mask,
    no dense table pass — the least work of the batch-SGD updates.
    Semantics vs the
    dedup path: clip applies to each occurrence's gradient rather than the
    per-row combined gradient — the reference live path's own ordering
    (sgd.cpp:14-26 clips per sample) — so the modes differ where the clip
    binds on duplicated rows. l2 regularization enters per occurrence
    against the forward-pass rows (``rows``; the dedup path reads the
    post-write-back table row — pass the aggregated rows for the user
    table to match).

    ``writeback`` replaces ``table[ids]`` before the update (the user
    table's aggregated-row write-back); ids == table.shape[0] drop.
    """
    if writeback is not None:
        table = table.at[ids].set(writeback.astype(table.dtype), mode="drop")
    g = jnp.clip(grads, -clip_val, clip_val)
    if l2:
        if rows is None:
            raise ValueError("l2 under update_mode='direct' needs rows")
        g = g + l2 * rows.astype(g.dtype)
    inc = (-lr * g).astype(table.dtype)
    return table.at[ids].add(inc, mode="drop")


def _apply_row_updates_dense(
    table, ids, grads, *, lr, clip_val, gacc, decay, l2
):
    """Dense-accumulator path: no sort; duplicates combine in scatter-add."""
    num_rows = table.shape[0]
    acc = jnp.zeros(table.shape, jnp.float32).at[ids].add(grads, mode="drop")
    if l2 or gacc is not None:
        touched = (
            jnp.zeros((num_rows, 1), jnp.float32)
            .at[ids]
            .add(jnp.ones((ids.shape[0], 1), jnp.float32), mode="drop")
        )
        touched = jnp.minimum(touched, 1.0)
    if l2:
        acc = acc + l2 * table.astype(jnp.float32) * touched
    if gacc is None:
        g = jnp.clip(acc, -clip_val, clip_val)
        return (table - (lr * g).astype(table.dtype)), None
    new_acc = jnp.clip(decay * gacc + acc, -clip_val, clip_val)
    new_gacc = jnp.where(touched > 0, new_acc, gacc)
    new_table = table - (lr * new_acc * touched).astype(table.dtype)
    return new_table, new_gacc


@jax.named_scope("aggr_b")
def dense_opt_update(
    param: jnp.ndarray,
    g: jnp.ndarray,
    slots: dict,
    name: str,
    *,
    lr: jnp.ndarray,
    step: jnp.ndarray,
    beta1: float,
    beta2: float,
    eps: float,
) -> tuple[jnp.ndarray, dict]:
    """Adagrad/Adam update of a dense (replicated) parameter like w0.

    ``slots`` holds "{name}_v" (and "{name}_m" for Adam); returns the
    updated parameter and slots. ``step`` is the 1-based global step used
    for Adam bias correction.
    """
    g = g.astype(jnp.float32)
    new_slots = dict(slots)
    if f"{name}_m" in slots:  # adam
        t = step.astype(jnp.float32)
        m = beta1 * slots[f"{name}_m"] + (1.0 - beta1) * g
        v = beta2 * slots[f"{name}_v"] + (1.0 - beta2) * g * g
        m_hat = m / (1.0 - beta1**t)
        v_hat = v / (1.0 - beta2**t)
        upd = m_hat / (jnp.sqrt(v_hat) + eps)
        new_slots[f"{name}_m"] = m
    else:  # adagrad
        v = slots[f"{name}_v"] + g * g
        upd = g / (jnp.sqrt(v) + eps)
    new_slots[f"{name}_v"] = v
    return param - (lr * upd).astype(param.dtype), new_slots


@jax.named_scope("write_emb")
def apply_row_updates_opt(
    table: jnp.ndarray,
    ids: jnp.ndarray,
    grads: jnp.ndarray,
    *,
    lr: jnp.ndarray,
    clip_val: float,
    step: jnp.ndarray,
    m: Optional[jnp.ndarray],
    v: jnp.ndarray,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    l2: float = 0.0,
    writeback: Optional[jnp.ndarray] = None,
) -> tuple[jnp.ndarray, Optional[jnp.ndarray], jnp.ndarray]:
    """Row-sparse Adagrad (m is None) / lazy Adam row update.

    Same duplicate-combine + clip-the-combined-row semantics as
    :func:`apply_row_updates`, but the clipped gradient feeds a moment-based
    transform instead of plain SGD. Moments are "lazy": only touched rows
    update (torch SparseAdam semantics — untouched rows neither decay nor
    bias-correct; Adam bias correction uses the 1-based global ``step``).
    ``writeback`` replaces ``table[ids]`` before the update (fused into the
    one row scatter on the sorted path — see :func:`apply_row_updates`).

    Returns (new_table, new_m, new_v).
    """
    if table.shape[0] <= DENSE_ROWS_THRESHOLD:
        if writeback is not None:
            table = table.at[ids].set(
                writeback.astype(table.dtype), mode="drop"
            )
        return _apply_row_updates_opt_dense(
            table, ids, grads, lr=lr, clip_val=clip_val, step=step,
            m=m, v=v, beta1=beta1, beta2=beta2, eps=eps, l2=l2,
        )
    return _apply_row_updates_opt_sorted(
        table, ids, grads, lr=lr, clip_val=clip_val, step=step,
        m=m, v=v, beta1=beta1, beta2=beta2, eps=eps, l2=l2,
        writeback=writeback,
    )


def _apply_row_updates_opt_dense(
    table, ids, grads, *, lr, clip_val, step, m, v, beta1, beta2, eps, l2
):
    num_rows = table.shape[0]
    acc = jnp.zeros(table.shape, jnp.float32).at[ids].add(grads, mode="drop")
    touched = (
        jnp.zeros((num_rows, 1), jnp.float32)
        .at[ids]
        .add(jnp.ones((ids.shape[0], 1), jnp.float32), mode="drop")
    )
    touched = jnp.minimum(touched, 1.0)
    if l2:
        acc = acc + l2 * table.astype(jnp.float32) * touched
    g = jnp.clip(acc, -clip_val, clip_val)
    if m is None:  # adagrad: untouched rows have g == 0, v unchanged
        new_v = v + g * g
        upd = g / (jnp.sqrt(new_v) + eps) * touched
        return table - (lr * upd).astype(table.dtype), None, new_v
    t = step.astype(jnp.float32)
    new_m = jnp.where(touched > 0, beta1 * m + (1.0 - beta1) * g, m)
    new_v = jnp.where(touched > 0, beta2 * v + (1.0 - beta2) * g * g, v)
    m_hat = new_m / (1.0 - beta1**t)
    v_hat = new_v / (1.0 - beta2**t)
    upd = m_hat / (jnp.sqrt(v_hat) + eps) * touched
    return table - (lr * upd).astype(table.dtype), new_m, new_v


def _sorted_dedup_with_base(ids, grads, num_rows, writeback):
    """Sorted dedup that also picks each unique id's write-back row
    (first occurrence in sorted order). Returns (rep_ids, summed, base)."""
    m = ids.shape[0]
    order = jnp.argsort(ids)
    sid = ids[order]
    starts = jnp.concatenate(
        [jnp.ones((1,), dtype=bool), sid[1:] != sid[:-1]]
    )
    seg = jnp.cumsum(starts) - 1
    summed = jax.ops.segment_sum(grads[order], seg, num_segments=m)
    rep_ids = jnp.full((m,), num_rows, dtype=ids.dtype).at[seg].set(sid)
    first_pos = (
        jnp.full((m,), m - 1, jnp.int32)
        .at[seg]
        .min(jnp.arange(m, dtype=jnp.int32))
    )
    base = writeback[order[first_pos]].astype(jnp.float32)  # (m, d)
    return rep_ids, summed, base


def _apply_row_updates_opt_sorted(
    table, ids, grads, *, lr, clip_val, step, m, v, beta1, beta2, eps, l2,
    writeback=None,
):
    num_rows = table.shape[0]
    if writeback is None:
        rep_ids, summed = segment_sum_by_id(ids, grads, num_rows)
        base = None
    else:
        rep_ids, summed, base = _sorted_dedup_with_base(
            ids, grads, num_rows, writeback
        )
    safe = jnp.minimum(rep_ids, num_rows - 1)
    valid = (rep_ids < num_rows).astype(jnp.float32)[:, None]
    if l2:
        rows = base if base is not None else table[safe].astype(jnp.float32)
        summed = summed + l2 * rows * valid
    g = jnp.clip(summed, -clip_val, clip_val) * valid
    if m is None:  # adagrad
        v_rows = v[safe]
        new_v_rows = v_rows + g * g
        upd = g / (jnp.sqrt(new_v_rows) + eps)
        if base is None:
            new_table = table.at[rep_ids].add(
                (-lr * upd).astype(table.dtype), mode="drop"
            )
        else:
            new_table = table.at[rep_ids].set(
                (base - lr * upd).astype(table.dtype), mode="drop"
            )
        new_v = v.at[rep_ids].set(new_v_rows, mode="drop")
        return new_table, None, new_v
    t = step.astype(jnp.float32)
    new_m_rows = beta1 * m[safe] + (1.0 - beta1) * g
    new_v_rows = beta2 * v[safe] + (1.0 - beta2) * g * g
    m_hat = new_m_rows / (1.0 - beta1**t)
    v_hat = new_v_rows / (1.0 - beta2**t)
    upd = m_hat / (jnp.sqrt(v_hat) + eps) * valid
    if base is None:
        new_table = table.at[rep_ids].add(
            (-lr * upd).astype(table.dtype), mode="drop"
        )
    else:
        new_table = table.at[rep_ids].set(
            (base - lr * upd).astype(table.dtype), mode="drop"
        )
    new_m = m.at[rep_ids].set(new_m_rows, mode="drop")
    new_v = v.at[rep_ids].set(new_v_rows, mode="drop")
    return new_table, new_m, new_v


def _apply_row_updates_sorted(
    table, ids, grads, *, lr, clip_val, gacc, decay, l2, writeback=None
):
    """Sort-dedup path for huge tables: O(M log M), no O(rows) pass."""
    num_rows = table.shape[0]
    if writeback is not None:
        # Fused write-back + update: one row scatter total.
        rep_ids, summed, base = _sorted_dedup_with_base(
            ids, grads, num_rows, writeback
        )
        if l2:
            valid = (rep_ids < num_rows).astype(jnp.float32)[:, None]
            summed = summed + l2 * base * valid
        g = jnp.clip(summed, -clip_val, clip_val)
        new_table = table.at[rep_ids].set(
            (base - lr * g).astype(table.dtype), mode="drop"
        )
        return new_table, None
    rep_ids, summed = segment_sum_by_id(ids, grads, num_rows)
    if l2:
        safe = jnp.minimum(rep_ids, num_rows - 1)
        rows = table[safe]
        valid = (rep_ids < num_rows).astype(table.dtype)[:, None]
        summed = summed + l2 * rows * valid
    if gacc is None:
        g = jnp.clip(summed, -clip_val, clip_val)
        new_table = table.at[rep_ids].add(
            (-lr * g).astype(table.dtype), mode="drop"
        )
        return new_table, None
    safe = jnp.minimum(rep_ids, num_rows - 1)
    valid = (rep_ids < num_rows).astype(table.dtype)[:, None]
    acc_rows = gacc[safe] * valid
    acc_new = jnp.clip(decay * acc_rows + summed, -clip_val, clip_val)
    new_table = table.at[rep_ids].add(
        (-lr * acc_new).astype(table.dtype), mode="drop"
    )
    new_gacc = gacc.at[rep_ids].set(acc_new.astype(gacc.dtype), mode="drop")
    return new_table, new_gacc
