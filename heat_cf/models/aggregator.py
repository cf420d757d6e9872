"""SimpleX behavior aggregation.

The reference BehaviorAggregator (behavior_aggregators.cpp:51-127) mean-pools
the first ``num_his = mask[user]`` rows of the user's history-item embeddings,
applies a learned (d, d) linear map ``weights0``, and blends

    u_agg = gamma * u + (1 - gamma) * (mean @ weights0)        (gamma = 0.4)

Backward (behavior_aggregators.cpp:129-153):
* weights0's gradient is the outer product means^T (1-gamma) dL/du_agg —
  exactly what autodiff of this forward yields;
* the upstream user gradient is scaled by gamma — again exactly autodiff;
* NO gradient flows into the item embeddings through the history mean (the
  reference backward stops there), so callers must pass history embeddings
  through ``jax.lax.stop_gradient``.

History padding semantics (datasets.py:47-61): rows beyond mask repeat the
last item (or are zeros when the user has no history) and are excluded from
the mean by masking on position < mask; empty histories use a guarded
divisor (the reference divides by zero there and warns — we clamp).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def _prec(dtype) -> jax.lax.Precision:
    """HIGHEST for genuinely-f32 operands (at default precision the GPU
    runs an f32 matmul in TF32, a 10-bit mantissa — a silent fidelity loss
    for compute_dtype=float32; bf16 operands lose nothing either way)."""
    return (
        jax.lax.Precision.HIGHEST
        if dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )


def history_mean(
    his_embs: jnp.ndarray, mask: jnp.ndarray
) -> jnp.ndarray:
    """Masked mean over the first ``mask`` history rows.

    Args:
      his_embs: (B, H, d) gathered history item embeddings.
      mask: (B,) int — valid history length per user.

    Returns:
      (B, d) means.
    """
    b, h, _ = his_embs.shape
    pos = jnp.arange(h, dtype=mask.dtype)[None, :]  # (1, H)
    valid = (pos < mask[:, None]).astype(his_embs.dtype)  # (B, H)
    # Accumulate in f32 and round ONCE at the end: bf16 products already
    # accumulate in f32 in the tensor cores, so preferred_element_type=f32
    # is free — without it the sum rounds to bf16 and the divide rounds
    # again (~2 ulp drift vs an f32 oracle).
    total = jnp.einsum(
        "bhd,bh->bd",
        his_embs,
        valid,
        precision=_prec(his_embs.dtype),
        preferred_element_type=jnp.float32,
    )
    denom = jnp.maximum(mask.astype(jnp.float32), 1.0)
    return (total / denom[:, None]).astype(his_embs.dtype)


def history_mean_fused(
    item_emb: jnp.ndarray,
    his_ids: jnp.ndarray,
    mask: jnp.ndarray,
    compute_dtype=None,
) -> jnp.ndarray:
    """Masked history mean fused with its own gather, in small H-chunks.

    ``history_mean`` consumes an already-materialized (B, H, d) gather;
    at exact-mode geometry (8192 x 100 x 64 f32) that intermediate is
    210 MB of device-memory write+read per step. Gathering in chunks of
    C history slots and feeding each (B, C, d) chunk straight into a
    masked contraction keeps the intermediate small (C = 5 for f32, 10
    for bf16: chosen by a sweep on the previous accelerator, not
    re-derived on the GPU yet — see ROADMAP). The contraction runs at
    HIGHEST precision for f32 (cheap here — the phase is gather-bound;
    the GPU's default would run it in TF32) and DEFAULT for bf16 (exact),
    always accumulating in f32 across chunks with ONE terminal
    rounding.

    Args:
      item_emb: (I, d) table (any float dtype).
      his_ids: (B, H) int32 history ids (any values; masking is
        positional, so H not divisible by C is padded with id 0 — the
        pad positions are >= H >= mask and carry zero mask weight).
      mask: (B,) int — valid history length per user.
      compute_dtype: dtype the contraction (and result) runs in;
        defaults to item_emb.dtype.

    Returns:
      (B, d) means in compute_dtype (empty histories pool to zero).
    """
    compute = jnp.dtype(
        item_emb.dtype if compute_dtype is None else compute_dtype
    )
    b, h = his_ids.shape
    d = item_emb.shape[1]
    c = 5 if compute == jnp.float32 else 10
    if h <= c:
        # Single chunk: the loop+dynamic_slice wrapper is pure overhead
        # restructuring (the temp it would avoid is already small), and
        # inside large epoch programs it was harmful on the previous
        # accelerator: at the 16M-user bench_large geometry (H=10, bf16)
        # wrapping this one contraction in a fori_loop slowed the epoch
        # about sevenfold.
        # Emit the one masked contraction directly (identical math).
        valid = (
            jnp.arange(h, dtype=mask.dtype)[None, :] < mask[:, None]
        ).astype(compute)
        total = jnp.einsum(
            "bhd,bh->bd",
            item_emb[his_ids].astype(compute),
            valid,
            precision=_prec(compute),
            preferred_element_type=jnp.float32,
        )
        denom = jnp.maximum(mask.astype(jnp.float32), 1.0)
        return (total / denom[:, None]).astype(compute)
    hp = -(-h // c) * c
    if hp != h:
        his_ids = jnp.concatenate(
            [his_ids, jnp.zeros((b, hp - h), his_ids.dtype)], axis=1
        )

    def body(i, acc):
        sl = jax.lax.dynamic_slice(his_ids, (0, i * c), (b, c))
        valid = (
            i * c + jnp.arange(c, dtype=mask.dtype)[None, :]
            < mask[:, None]
        ).astype(compute)
        return acc + jnp.einsum(
            "bcd,bc->bd",
            item_emb[sl].astype(compute),
            valid,
            precision=_prec(compute),
            preferred_element_type=jnp.float32,
        )

    total = jax.lax.fori_loop(
        0, hp // c, body, jnp.zeros((b, d), jnp.float32)
    )
    denom = jnp.maximum(mask.astype(jnp.float32), 1.0)
    return (total / denom[:, None]).astype(compute)


def pool_history(
    his_embs: jnp.ndarray,
    mask: jnp.ndarray,
    u: Optional[jnp.ndarray] = None,
    attn_q: Optional[jnp.ndarray] = None,
    kind: str = "mean",
    logical_dim: Optional[int] = None,
) -> jnp.ndarray:
    """History pooling with the SimpleX aggregation menu.

    The reference names three aggregation choices — "average pooling,
    self-attention, and user-attention" (behavior_aggregators.cpp:27) — but
    implements only average pooling; the attention variants back the paper's
    ACCL results (ICS'23 section 5.2). All three are provided here:

    * ``mean``: masked mean over the valid history rows (the reference's
      live path, behavior_aggregators.cpp:96-105);
    * ``self_attention``: scaled dot-product attention against a learned
      (d,) query vector ``attn_q`` — a_i = softmax(h_i . q / sqrt(d));
    * ``user_attention``: the user's own embedding is the query —
      a_i = softmax(h_i . u / sqrt(d)).

    In every variant no gradient flows into the history item rows (callers
    stop_gradient the gather, matching behavior_aggregators.cpp:129-153);
    attention gradients flow to ``attn_q`` (self) / ``u`` (user) by autodiff.
    Users with empty histories pool to the zero vector.
    """
    if kind == "mean":
        return history_mean(his_embs, mask)
    _, h, d = his_embs.shape
    pos = jnp.arange(h, dtype=mask.dtype)[None, :]  # (1, H)
    valid = pos < mask[:, None]  # (B, H)
    # Softmax temperature scales by the LOGICAL embedding width: under
    # emb_pad the physical minor dim carries zero tails that contribute
    # nothing to the logits, and silently lowering the temperature by
    # sqrt(pad/d) would change the attention math (the old emb_pad x
    # attention config restriction — lifted by this parameter).
    scale = jnp.asarray(
        d if logical_dim is None else logical_dim, his_embs.dtype
    ) ** -0.5
    if kind == "self_attention":
        if attn_q is None:
            raise ValueError("self_attention requires attn_q")
        logits = (
            jnp.einsum(
                "bhd,d->bh", his_embs, attn_q, precision=_prec(his_embs.dtype)
            )
            * scale
        )
    elif kind == "user_attention":
        if u is None:
            raise ValueError("user_attention requires the user embeddings")
        logits = (
            jnp.einsum(
                "bhd,bd->bh", his_embs, u, precision=_prec(his_embs.dtype)
            )
            * scale
        )
    else:
        raise ValueError(f"unknown aggregator {kind!r}")
    # Keep slot 0 un-masked so the softmax is never all -inf and can emit
    # no NaN (whose cotangent would poison attn_q/u even through a
    # selecting where()). For empty-history users slot 0 holds padding id 0
    # — a REAL item row — so the final where() on mask is what actually
    # zeroes their pooled output; do not remove it.
    never_empty = valid | (pos == 0)
    logits = jnp.where(never_empty, logits, jnp.asarray(-1e9, logits.dtype))
    attn = jax.nn.softmax(logits, axis=-1)
    pooled = jnp.einsum(
        "bh,bhd->bd", attn, his_embs, precision=_prec(his_embs.dtype)
    )
    return jnp.where(mask[:, None] > 0, pooled, jnp.zeros_like(pooled))


def user_pools_impl(
    item_emb: jnp.ndarray,
    his_items: jnp.ndarray,
    his_masks: jnp.ndarray,
    user_emb: Optional[jnp.ndarray] = None,
    attn_q: Optional[jnp.ndarray] = None,
    aggregator: str = "mean",
    chunk: int = 4096,
    max_his: Optional[int] = None,
    logical_dim: Optional[int] = None,
) -> jnp.ndarray:
    """Per-user pooled history over the whole user table, in chunks.

    Backs cfg.his_refresh == "subepoch": one pass over U*H history rows per
    (sub-)epoch instead of B*H rows per step (each user is revisited
    ~train_size/U times per epoch, so this cuts the dominant gather traffic
    by that factor at the cost of pooled-history staleness within the
    period). Supports every cfg.aggregator; the attention variants pool
    with the refresh-time query (attn_q / user rows), consistent with the
    mode's staleness contract.

    ``his_items`` may be (U, H), or flat (U*H,) with ``max_his`` = H — the
    layout Engine uses for small H (see Engine's history layout note).
    Chunks are carved with dynamic_slice (never a reshaped/ concatenated
    copy of the whole table — at large U those temps run out of device
    memory).

    Traceable (no jit inside): the epoch program calls this directly so the
    means table is PRODUCED in the layout the epoch scan consumes — passing
    it across a jit boundary instead costs a full-table layout copy (~5 GB
    at 20M users x d=64 f32).
    """
    if his_items.ndim == 1:
        if max_his is None:
            raise ValueError("flat his_items requires max_his")
        h = max_his
        u = his_items.shape[0] // h
    else:
        u, h = his_items.shape
    d = item_emb.shape[1]
    chunk = min(chunk, u)
    n_chunks = -(-u // chunk)

    def body(i, out):
        # Clamp the partial last chunk to u - chunk EXPLICITLY so every
        # dynamic_slice/dynamic_update_slice below gets an in-range offset
        # (overlap rows recompute with identical values). Do NOT rely on
        # the ops' implicit out-of-range clamping: a backend may clamp the
        # reads and the update to DIFFERENT offsets (one accelerator
        # clamped the update to a tile-aligned row), shearing
        # ids/mask/output alignment for every row in the last-chunk
        # window — at AmazonBooks scale the final 4131 users then train
        # on means pooled with the wrong masks. CPU tests cannot see it;
        # tests_gpu/ carries the on-device regression test.
        start = jnp.minimum(i * chunk, u - chunk)
        if his_items.ndim == 1:
            ids = jax.lax.dynamic_slice(
                his_items, (start * h,), (chunk * h,)
            ).reshape(chunk, h)
        else:
            ids = jax.lax.dynamic_slice(his_items, (start, 0), (chunk, h))
        mask = jax.lax.dynamic_slice(his_masks, (start,), (chunk,))
        urows = None
        if aggregator == "user_attention":
            urows = jax.lax.dynamic_slice(
                user_emb, (start, 0), (chunk, user_emb.shape[1])
            )
        if aggregator == "mean":
            # Fused chunked gather+contraction — avoids materializing
            # the (chunk, H, d) history gather (see history_mean_fused).
            pooled = history_mean_fused(item_emb, ids, mask)
        else:
            pooled = pool_history(
                item_emb[ids], mask, u=urows, attn_q=attn_q,
                kind=aggregator, logical_dim=logical_dim,
            )
        return jax.lax.dynamic_update_slice(out, pooled, (start, 0))

    out = jnp.zeros((u, d), item_emb.dtype)
    return jax.lax.fori_loop(0, n_chunks, body, out)


def aggregate_history(
    u: jnp.ndarray,
    means: jnp.ndarray,
    w0: jnp.ndarray,
    gamma: float,
) -> jnp.ndarray:
    """u_agg = gamma * u + (1 - gamma) * means @ w0.

    (behavior_aggregators.cpp:118-122; w0 orientation matches the
    reference's ``means.matrix() * weights0.matrix()``.)
    """
    # HIGHEST when genuinely f32: at default precision the GPU runs an
    # f32 matmul in TF32 (no loss for bf16-valued inputs, a fidelity loss
    # for compute_dtype=float32). d x d — negligible FLOPs.
    prec = (
        jax.lax.Precision.HIGHEST
        if means.dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )
    f_c0 = jnp.dot(
        means, w0, preferred_element_type=means.dtype, precision=prec
    )
    return gamma * u + (1.0 - gamma) * f_c0
