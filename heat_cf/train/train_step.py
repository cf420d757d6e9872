"""The fused training step: gather -> score -> loss -> grad -> scatter.

This replaces the reference's per-sample C++ kernel
(``MatrixFactorization::forward_backward``, matrix_factorization.cpp:15-181)
with one jitted, batched step:

1. gather user/positive/negative/history embedding rows (the reference's
   read_row memcpys, matrix_factorization.cpp:31-32, 69-80;
   behavior_aggregators.cpp:96-101);
2. behavior aggregation (mean-pool + weights0 + gamma blend) — history
   embeddings pass through stop_gradient because the reference backward
   does not propagate into item embeddings via the mean
   (behavior_aggregators.cpp:129-153);
3. cosine (or dot) similarity + contrastive loss, with gradients by
   autodiff — mathematically identical to the reference's hand-derived
   cosine gradients that reuse forward dot products
   (matrix_factorization.cpp:62-63, 136-143);
4. duplicate-safe segment-sum scatter updates with elementwise clipping
   (sgd.cpp:14-26, optimizer.cpp:17-22), including the reference's write-back
   of the *aggregated* user embedding into the user table
   (matrix_factorization.cpp:166-171: sparse_step updates the buffer that
   holds u_agg, then write_row stores it);
5. aggregator weights0 update: the reference applies
   ``w0 -= lr * mean(grad over 32 samples)`` every 32 samples
   (behavior_aggregators.cpp:141-146); a batch of B collapses B/32 such
   updates into one: ``w0 -= lr * sum_batch(grad_w0) / 32``.

Padded batch entries carry weight 0: their losses and gradients vanish and
their user rows are redirected to an out-of-bounds drop slot so the
aggregated write-back cannot touch real rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from heat_cf.config import CFConfig
from heat_cf.models.aggregator import (
    aggregate_history,
    history_mean_fused,
    pool_history,
)
from heat_cf.models.state import TrainState
from heat_cf.ops.losses import sample_losses, sample_losses_weighted
from heat_cf.ops.similarity import pair_scores, tile_scores
from heat_cf.train.samplers import SamplerState, sample_negatives
from heat_cf.train.scatter import (
    apply_row_updates,
    apply_row_updates_direct,
    apply_row_updates_opt,
    dense_opt_update,
)


class Batch(NamedTuple):
    users: jnp.ndarray   # (B,) int32
    pos: jnp.ndarray     # (B,) int32
    weight: jnp.ndarray  # (B,) f32 — 1 for real samples, 0 for padding


def _refresh_pools(cfg: CFConfig, state, his_items, his_masks):
    """The per-(sub-)epoch pooled-history refresh shared by every epoch
    program builder: None unless cfg.his_refresh == "subepoch", else the
    (U, d) pooled table computed INSIDE the program from the live state
    (so it materializes in the consuming layout — see make_epoch_fn)."""
    if cfg.his_refresh != "subepoch":
        return None
    from heat_cf.models.aggregator import user_pools_impl

    return user_pools_impl(
        state.item_emb,
        his_items,
        his_masks,
        user_emb=(
            state.user_emb if cfg.aggregator == "user_attention" else None
        ),
        attn_q=state.attn_q,
        aggregator=cfg.aggregator,
        max_his=cfg.max_his,
        logical_dim=cfg.emb_dim if cfg.emb_pad else None,
    )


def train_step(
    state: TrainState,
    sampler_state: SamplerState,
    key: jax.Array,
    batch: Batch,
    his_items: jnp.ndarray,
    his_masks: jnp.ndarray,
    cfg: CFConfig,
    neg_candidates: Optional[jnp.ndarray] = None,
    user_means: Optional[jnp.ndarray] = None,
    uniq_users: Optional[jnp.ndarray] = None,
    uniq_inverse: Optional[jnp.ndarray] = None,
    neg_candidates_size: Optional[jnp.ndarray] = None,
    uniq_first: Optional[jnp.ndarray] = None,
) -> tuple[TrainState, SamplerState, jnp.ndarray]:
    """One fused minibatch step. Returns (state', sampler_state', loss_sum).

    neg_candidates: optional (C,) item-id pool to constrain negatives to
      (the sub-epoch partition-complement sampling of engine.cpp:222-237);
      None draws from the full item space.
    neg_candidates_size: optional traced scalar — the VALID prefix length
      of ``neg_candidates`` (the fused sub-epoch program pads every
      sub-epoch's complement pool to one static width; draws index
      ``pool[draw % size]`` so pad entries are never selected and the
      sampling distribution matches the unpadded pool exactly).
    user_means: optional precomputed (U, d) pooled-history table
      (cfg.his_refresh == "subepoch", any cfg.aggregator); None recomputes
      from the live item table per step (reference semantics).
    uniq_users / uniq_inverse: optional history-gather dedup
      (his_refresh == "step" only): uniq_users (Bu,) lists the batch's
      distinct user ids (padded by repetition), uniq_inverse (B,) maps
      each sample to its slot. All reads in a batched step happen at
      batch start, so duplicate users provably receive IDENTICAL pooled
      histories — gathering H history rows once per DISTINCT user is
      therefore an exact rewrite that cuts the step's dominant
      row-gather traffic by the duplication factor (~clicks-per-user for
      parse-order streams, the fork's live MPI visit order,
      engine.cpp:243-252). Engine precomputes these host-side per epoch
      (shuffle_mode == "none").
    uniq_first: (Bu,) index of each distinct user's FIRST occurrence in
      the batch (round 5 — required for the attention aggregators'
      dedup, unused for mean): user_attention's query is the user row,
      so per-uniq pooling slices ``u_rows[uniq_first]`` from the same
      differentiable occurrence gather — duplicates carry identical
      batch-start rows, and the query gradient flows back through the
      existing u_rows scatter with no new plumbing.
    """
    users, pos, weight = batch
    # Real (non-padding) sample count: drives the sampler's iteration
    # counter / tile-refresh cadence and the optimizer step counter, so
    # weight-0 padding batches (fused sub-epoch programs pad ragged
    # buckets with whole batches) are true no-ops for both.
    real = jnp.sum(weight).astype(jnp.int32)
    # jax.named_scope labels below follow the reference's 15-phase
    # time_map taxonomy (thread_buffer.hpp:32-46) so profiler traces
    # (--profile-dir) map onto Engine::performance_breakdown's tree
    # (engine.cpp:22-65). Negative sampling is stamped "data" like the
    # reference's sample-read+sampling block (engine.cpp:326-335).
    with jax.named_scope("data"):
        sample, sampler_state = sample_negatives(
            key, sampler_state, pos, cfg, real=real
        )
    negs = sample.ids
    # The tile fast path keeps negative gathers/scatters inside the
    # T-row tile (HEAT's cache-tiling insight mapped to a small working
    # set + matmul-friendly segment-sum). It composes with constrained
    # sampling (sub-epoch partitioning) by remapping the TILE through the
    # complement pool — elementwise identical ids to remapping the draws
    # (pool[tile % size][idx] == pool[tile[idx] % size]) at T remap
    # gathers instead of B*K, and the whole-tile scoring/update survives.
    # (Accum mode treats every updated id as "touched", so
    # folding grads onto all T tile rows would wrongly re-apply
    # accumulated rows with zero fresh gradient — tile fast path is
    # batch-mode only.)
    tiled = sample.tile is not None and state.item_gacc is None
    tile_ids = sample.tile
    if neg_candidates is not None:
        # Constrained sampling: reinterpret draws as indices into the pool.
        pool_size = (
            neg_candidates.shape[0]
            if neg_candidates_size is None
            else neg_candidates_size
        )
        if tiled:
            tile_ids = neg_candidates[sample.tile % pool_size]
        else:
            negs = neg_candidates[negs % pool_size]

    user_emb, item_emb, w0 = state.user_emb, state.item_emb, state.w0
    compute = jnp.dtype(cfg.compute_dtype)

    with jax.named_scope("read_emb"):
        u_rows = user_emb[users].astype(compute)
        p_rows = item_emb[pos].astype(compute)
    if tiled:
        # Whole-tile scoring: gather the T tile rows once and score every
        # user against all of them in one matmul; the K sampled draws enter
        # only as per-(sample, slot) multiplicities. This avoids both
        # (B, K)-indexed gathers (ids and rows) and the (B*K)-row gradient
        # fold — the tile gradient is the transposed score matmul.
        with jax.named_scope("read_emb"):
            n_rows = item_emb[tile_ids].astype(compute)  # (T, d)
        # Draw multiplicities by fused compare-reduce over the tile axis:
        # one elementwise pass instead of a (B*K)-element scatter-add.
        t_iota = jnp.arange(sample.tile.shape[0], dtype=jnp.int32)
        counts = jnp.sum(
            (sample.tile_idx[:, :, None] == t_iota).astype(jnp.float32),
            axis=1,
        )
    else:
        with jax.named_scope("read_emb"):
            n_rows = item_emb[negs].astype(compute)
    # History pooling (cfg.aggregator: mean | self_attention |
    # user_attention). The mean is constant w.r.t. the differentiated
    # inputs, so it is computed outside the loss; the attention variants'
    # weights depend on attn_q / u_rows and pool inside it (autodiff
    # provides the attention gradients). History item rows never receive
    # gradient in any variant (behavior_aggregators.cpp:129-153).
    his_embs = his_mask_b = None
    uniq_embs = uniq_mask = None
    pooled_const = None
    if user_means is not None:
        with jax.named_scope("read_his"):
            pooled_const = jax.lax.stop_gradient(
                user_means[users]
            ).astype(compute)
    elif uniq_users is not None and cfg.aggregator == "mean":
        # Dedup path: H-row history gathers once per DISTINCT batch user,
        # then a cheap (B,) gather of the d-wide means. Exact: within a
        # batched step every read sees the batch-start tables, so
        # duplicate users' means are identical by construction.
        with jax.named_scope("read_his"):
            if his_items.ndim == 1:
                h = cfg.max_his
                his_ids = his_items[
                    uniq_users[:, None] * h
                    + jnp.arange(h, dtype=uniq_users.dtype)[None, :]
                ]
            else:
                his_ids = his_items[uniq_users]          # (Bu, H)
            # Chunked fused gather+contraction (see history_mean_fused).
            # Same formulation as the non-dedup branch — the per-user
            # chunk reduction order is identical regardless of batch
            # width, so dedup-on vs dedup-off is numerically identical
            # by reduction order (the equivalence test checks it at
            # rtol 1e-6; XLA fusion choices may still differ per shape).
            means_u = jax.lax.stop_gradient(
                history_mean_fused(
                    item_emb, his_ids, his_masks[uniq_users], compute
                )
            )
        with jax.named_scope("aggr_f"):
            pooled_const = means_u[uniq_inverse]         # (B, d)
    elif uniq_users is not None:
        # Attention dedup (round 5): history rows gathered once per
        # DISTINCT user; pooling is deferred to batch_loss because the
        # query (attn_q, or the user row for user_attention) is
        # differentiated. Exact by the same batch-start-read argument as
        # the mean dedup — duplicate users see identical rows, so
        # per-uniq pooling + an inverse gather equals per-occurrence
        # pooling, and the query gradient is the occurrence-summed one
        # (exact under combine-then-clip updates; Engine gates out
        # user_attention + update_mode="direct", whose per-occurrence
        # clip would bind differently on the concentrated row).
        if cfg.aggregator == "user_attention" and uniq_first is None:
            raise ValueError(
                "user_attention history dedup requires uniq_first "
                "(the per-uniq query slices the first occurrence of "
                "the differentiable u_rows gather)"
            )
        with jax.named_scope("read_his"):
            if his_items.ndim == 1:
                h = cfg.max_his
                his_ids = his_items[
                    uniq_users[:, None] * h
                    + jnp.arange(h, dtype=uniq_users.dtype)[None, :]
                ]
            else:
                his_ids = his_items[uniq_users]          # (Bu, H)
            uniq_embs = jax.lax.stop_gradient(
                item_emb[his_ids]
            ).astype(compute)
            uniq_mask = his_masks[uniq_users]
    else:
        with jax.named_scope("read_his"):
            if his_items.ndim == 1:
                # Flat (U*H,) layout (small max_his — see Engine's
                # history layout note).
                h = cfg.max_his
                his_ids = his_items[
                    users[:, None] * h
                    + jnp.arange(h, dtype=users.dtype)[None, :]
                ]
            else:
                his_ids = his_items[users]               # (B, H)
            if cfg.aggregator == "mean":
                # Chunked fused gather+contraction — never materializes
                # the (B, H, d) history gather (see history_mean_fused).
                with jax.named_scope("aggr_f"):
                    pooled_const = jax.lax.stop_gradient(
                        history_mean_fused(
                            item_emb, his_ids, his_masks[users], compute
                        )
                    )
            else:
                his_embs = jax.lax.stop_gradient(
                    item_emb[his_ids]
                ).astype(compute)
                his_mask_b = his_masks[users]

    def batch_loss(u_rows, p_rows, n_rows, w0, attn_q=None):
        if pooled_const is not None:
            means = pooled_const
        elif uniq_embs is not None:
            # Attention dedup: pool once per distinct user, then a cheap
            # (B,) d-wide gather. The user_attention query rides the
            # SAME differentiable occurrence gather (first occurrence —
            # duplicates are identical batch-start rows), so its
            # gradient reaches the u_rows scatter unchanged.
            with jax.named_scope("aggr_f"):
                pooled_u = pool_history(
                    uniq_embs,
                    uniq_mask,
                    u=(
                        u_rows[uniq_first]
                        if cfg.aggregator == "user_attention"
                        else None
                    ),
                    attn_q=None if attn_q is None else attn_q.astype(compute),
                    kind=cfg.aggregator,
                    logical_dim=cfg.emb_dim if cfg.emb_pad else None,
                )
                means = pooled_u[uniq_inverse]
        else:
            with jax.named_scope("aggr_f"):
                means = pool_history(
                    his_embs,
                    his_mask_b,
                    u=u_rows,
                    attn_q=None if attn_q is None else attn_q.astype(compute),
                    kind=cfg.aggregator,
                    logical_dim=cfg.emb_dim if cfg.emb_pad else None,
                )
        # "his_mm": the means x weights0 matmul + gamma blend
        # (behavior_aggregators.cpp:118-122).
        with jax.named_scope("his_mm"):
            u_agg = aggregate_history(
                u_rows, means, w0.astype(compute), cfg.gamma
            )
        with jax.named_scope("dot"):
            if tiled:
                s_up, S = tile_scores(
                    u_agg, p_rows, n_rows, similarity=cfg.similarity
                )
            else:
                s_up, s_un = pair_scores(
                    u_agg, p_rows, n_rows, similarity=cfg.similarity
                )
        with jax.named_scope("loss"):
            if tiled:
                losses = sample_losses_weighted(
                    s_up, S, counts, cfg.num_negs, cfg
                )
            else:
                losses = sample_losses(s_up, s_un, cfg)   # (B,)
        return jnp.sum(losses * weight), (u_agg, means)

    g_q = None
    with jax.named_scope("grad"):
        if cfg.aggregator == "self_attention":
            (loss_sum, (u_agg, means)), grads = jax.value_and_grad(
                batch_loss, argnums=(0, 1, 2, 3, 4), has_aux=True
            )(u_rows, p_rows, n_rows, w0, state.attn_q)
            g_u, g_p, g_n, g_w0, g_q = grads
        else:
            (loss_sum, (u_agg, means)), grads = jax.value_and_grad(
                batch_loss, argnums=(0, 1, 2, 3), has_aux=True
            )(u_rows, p_rows, n_rows, w0)
            g_u, g_p, g_n, g_w0 = grads

    if state.user_gacc is not None:
        # Reference fidelity (accum mode): the aggregator backward reuses the
        # persistent user-grad row, so its weights0 gradient includes the
        # stale accumulated grad in addition to the current sample's
        # (behavior_aggregators.cpp:131-139 operate on the accumulated
        # buffer). Autodiff covers the current-sample term; add the stale one.
        with jax.named_scope("aggr_b"):
            prev_acc = state.user_gacc[users].astype(jnp.float32)
            g_w0 = g_w0 + (1.0 - cfg.gamma) * jnp.einsum(
                "bi,bj->ij",
                means.astype(jnp.float32) * weight[:, None],
                prev_acc,
                precision=jax.lax.Precision.HIGHEST,  # f32 operands (see ops/similarity.py)
            )

    num_users = user_emb.shape[0]
    num_items = item_emb.shape[0]
    drop_user = jnp.asarray(num_users, users.dtype)
    drop_item = jnp.asarray(num_items, pos.dtype)
    valid = weight > 0
    users_w = jnp.where(valid, users, drop_user)
    pos_w = jnp.where(valid, pos, drop_item)

    # User table: the aggregated embedding replaces the row, then the
    # optimizer step (SGD in the reference; row-sparse Adagrad/Adam here
    # when cfg.optimizer selects them). In batch mode the write-back rides
    # the update's own scatter (scatter.apply_row_updates writeback=...);
    # accum mode keeps the explicit set (its update must read the
    # persistent grad rows, not fuse).
    l2 = cfg.l2 if cfg.l2_enabled else 0.0
    opt_slots = state.opt_slots
    # 1-based step for Adam bias correction; an all-padding batch is not
    # an optimizer step (it does not exist in the unfused dispatch shape).
    step1 = state.step + (real > 0).astype(state.step.dtype)
    if state.user_gacc is not None:
        user_emb = user_emb.at[users_w].set(
            u_agg.astype(user_emb.dtype), mode="drop"
        )
        u_writeback = None
    else:
        u_writeback = u_agg
    if cfg.update_mode == "direct":
        # Per-occurrence SGD increments, one scatter-add per table (config
        # validation guarantees batch-mode SGD here, so gacc is None).
        user_gacc = None
        user_emb = apply_row_updates_direct(
            user_emb,
            users_w,
            g_u.astype(jnp.float32),
            lr=state.lr,
            clip_val=cfg.clip_val,
            l2=l2,
            rows=u_agg if l2 else None,
            writeback=u_writeback,
        )
    elif cfg.optimizer == "sgd":
        user_emb, user_gacc = apply_row_updates(
            user_emb,
            users_w,
            g_u.astype(jnp.float32),
            lr=state.lr,
            clip_val=cfg.clip_val,
            gacc=state.user_gacc,
            decay=cfg.gamma,  # see scatter.apply_row_updates docstring
            l2=l2,
            writeback=u_writeback,
        )
    else:
        user_gacc = None
        opt_slots = dict(opt_slots)
        user_emb, new_m, new_v = apply_row_updates_opt(
            user_emb,
            users_w,
            g_u.astype(jnp.float32),
            lr=state.lr,
            clip_val=cfg.clip_val,
            step=step1,
            m=opt_slots.get("user_m"),
            v=opt_slots["user_v"],
            beta1=cfg.adam_beta1,
            beta2=cfg.adam_beta2,
            eps=cfg.opt_eps,
            l2=l2,
            writeback=u_writeback,
        )
        if new_m is not None:
            opt_slots["user_m"] = new_m
        opt_slots["user_v"] = new_v

    # Item table: positives and negatives in one deduplicated scatter.
    if tiled:
        # g_n already IS the per-tile-row gradient (T, d): autodiff of the
        # whole-tile matmul sums the sampled draws' contributions, so the
        # table update touches B + T rows instead of B * (1 + K).
        item_ids = jnp.concatenate([pos_w, tile_ids])
        item_grads = jnp.concatenate(
            [g_p.astype(jnp.float32), g_n.astype(jnp.float32)]
        )
    else:
        negs_w = jnp.where(valid[:, None], negs, drop_item)
        item_ids = jnp.concatenate([pos_w, negs_w.reshape(-1)])
        item_grads = jnp.concatenate(
            [
                g_p.astype(jnp.float32),
                g_n.reshape(-1, g_n.shape[-1]).astype(jnp.float32),
            ]
        )
    if cfg.update_mode == "direct":
        item_gacc = None
        item_rows = None
        if l2:
            item_rows = jnp.concatenate(
                [p_rows, n_rows if tiled else n_rows.reshape(-1, n_rows.shape[-1])]
            )
        item_emb = apply_row_updates_direct(
            item_emb,
            item_ids,
            item_grads,
            lr=state.lr,
            clip_val=cfg.clip_val,
            l2=l2,
            rows=item_rows,
        )
    elif cfg.optimizer == "sgd":
        item_emb, item_gacc = apply_row_updates(
            item_emb,
            item_ids,
            item_grads,
            lr=state.lr,
            clip_val=cfg.clip_val,
            gacc=state.item_gacc,
            decay=1.0,
            l2=l2,
        )
    else:
        item_gacc = None
        item_emb, new_m, new_v = apply_row_updates_opt(
            item_emb,
            item_ids,
            item_grads,
            lr=state.lr,
            clip_val=cfg.clip_val,
            step=step1,
            m=opt_slots.get("item_m"),
            v=opt_slots["item_v"],
            beta1=cfg.adam_beta1,
            beta2=cfg.adam_beta2,
            eps=cfg.opt_eps,
            l2=l2,
        )
        if new_m is not None:
            opt_slots["item_m"] = new_m
        opt_slots["item_v"] = new_v

    # Aggregator weights: B/aggr_minibatch reference updates collapsed.
    attn_q = state.attn_q
    if cfg.optimizer == "sgd":
        with jax.named_scope("aggr_b"):
            w0 = w0 - state.lr * g_w0.astype(w0.dtype) / cfg.aggr_minibatch
            if g_q is not None:
                attn_q = (
                    attn_q
                    - state.lr * g_q.astype(attn_q.dtype) / cfg.aggr_minibatch
                )
    else:
        # Dense (replicated) moment updates are NOT no-ops at zero
        # gradient (Adam decays moments; Adagrad divides by sqrt(v)), so
        # gate them on the batch containing real samples — an all-padding
        # batch must leave w0/attn_q and their slots untouched, exactly
        # like the unfused dispatch shape where it does not exist. The
        # row-sparse table updates need no gate (padding ids drop).
        has_real = real > 0

        def _gated(name, param, new_param, new_slots, slots):
            slots = dict(slots)
            for suf in ("_m", "_v"):
                kname = name + suf
                if kname in new_slots:
                    slots[kname] = jnp.where(
                        has_real, new_slots[kname], slots[kname]
                    )
            return jnp.where(has_real, new_param, param), slots

        w0_new, slots_new = dense_opt_update(
            w0,
            g_w0 / cfg.aggr_minibatch,
            opt_slots,
            "w0",
            lr=state.lr,
            step=step1,
            beta1=cfg.adam_beta1,
            beta2=cfg.adam_beta2,
            eps=cfg.opt_eps,
        )
        w0, opt_slots = _gated("w0", w0, w0_new, slots_new, opt_slots)
        if g_q is not None:
            q_new, slots_new = dense_opt_update(
                attn_q,
                g_q / cfg.aggr_minibatch,
                opt_slots,
                "attn_q",
                lr=state.lr,
                step=step1,
                beta1=cfg.adam_beta1,
                beta2=cfg.adam_beta2,
                eps=cfg.opt_eps,
            )
            attn_q, opt_slots = _gated(
                "attn_q", attn_q, q_new, slots_new, opt_slots
            )

    state = state.replace(
        user_emb=user_emb,
        item_emb=item_emb,
        w0=w0,
        user_gacc=user_gacc,
        item_gacc=item_gacc,
        step=step1,
        attn_q=attn_q,
        opt_slots=opt_slots,
    )
    return state, sampler_state, loss_sum


def make_epoch_fn(cfg: CFConfig):
    """Build a jitted epoch (or sub-epoch) function scanning over batches.

    Returns f(state, sampler_state, key, users (nb,B), pos (nb,B),
              weight (nb,B), his_items, his_masks[, neg_candidates])
        -> (state, sampler_state, loss_sum)
    State and sampler state are donated, so an epoch is one device program
    with no host round-trips (the reference's epoch loop crosses the
    Python/C++ boundary once per epoch, engine.cpp:67; we match that).

    In cfg.his_refresh == "subepoch" mode the (U, d) pooled-history table is
    computed INSIDE this program (from the donated state) rather than passed
    in: produced in the layout the scan consumes, it needs no cross-jit
    layout copy (at 20M users x d=64 f32 that copy alone is ~5 GB).
    """

    def epoch_fn(
        state,
        sampler_state,
        key,
        users,
        pos,
        weight,
        his_items,
        his_masks,
        neg_candidates=None,
        uniq_users=None,
        uniq_inverse=None,
        uniq_first=None,
    ):
        num_batches = users.shape[0]
        keys = jax.random.split(key, num_batches)
        user_means = _refresh_pools(cfg, state, his_items, his_masks)

        have_uniq = uniq_users is not None
        have_first = have_uniq and uniq_first is not None

        def body(carry, xs):
            state, sampler_state = carry
            uf = None
            if have_first:
                k, u, p, w, uu, ui, uf = xs
            elif have_uniq:
                k, u, p, w, uu, ui = xs
            else:
                k, u, p, w = xs
                uu = ui = None
            state, sampler_state, loss = train_step(
                state,
                sampler_state,
                k,
                Batch(u, p, w),
                his_items,
                his_masks,
                cfg,
                neg_candidates=neg_candidates,
                user_means=user_means,
                uniq_users=uu,
                uniq_inverse=ui,
                uniq_first=uf,
            )
            return (state, sampler_state), loss

        xs = (keys, users, pos, weight)
        if have_uniq:
            xs = xs + (uniq_users, uniq_inverse)
        if have_first:
            xs = xs + (uniq_first,)
        (state, sampler_state), losses = jax.lax.scan(
            body, (state, sampler_state), xs
        )
        return state, sampler_state, jnp.sum(losses)

    return jax.jit(epoch_fn, donate_argnums=(0, 1))


def shuffle_pairs(key: jax.Array, pairs: jnp.ndarray, total: int):
    """Shuffle click pairs, padded by tiling to ``total`` rows.

    ONE sort-with-payload (random 32-bit keys carrying both id columns) —
    the same shuffle ``jax.random.permutation`` computes internally but
    without re-gathering the pairs through the permutation afterwards
    (one pass over the pairs fewer). The reference's
    equivalent is the ``random::Shuffle`` positive order (shuffle.hpp:13-48).

    Returns (users, pos), each (total,) int32.
    """
    n = pairs.shape[0]
    keys = jax.random.bits(key, (n,))
    _, su, sp = jax.lax.sort(
        (keys, pairs[:, 0], pairs[:, 1]), dimension=0, num_keys=1
    )
    if total > n:
        reps = -(-total // n)
        su = jnp.tile(su, reps)[:total]
        sp = jnp.tile(sp, reps)[:total]
    return su, sp


def make_multi_epoch_fn(cfg: CFConfig, mesh=None):
    """Build a jitted MULTI-epoch program: scan over epochs, each doing the
    epoch-order shuffle, the LR schedule step, the cached-pool refresh, and
    the batch scan — all on device.

    Calling ``make_epoch_fn``'s program once per epoch pays a fixed
    per-dispatch cost (plus the separately-dispatched shuffle) every epoch;
    at a 0.3 s epoch that overhead is ~10-25%. Here E epochs are ONE device
    program — the idiomatic XLA shape of the reference's outer driver loop
    (main.py:106-114), bounded by eval_interval in the CLI.

    Covers the single-process fast path (no sub-epoch item partitioning,
    per-epoch shuffle) — unsharded or over a GSPMD ``mesh``, where the
    on-device shuffle stays replicated and the packed batches are
    sharding-constrained over the "data" axis exactly like the per-epoch
    path's host-side ``device_put`` (Engine._make_batches), so the scanned
    step compiles to the same collective layout. Multi-process meshes use
    ``make_multi_epoch_stream_fn`` instead (each process holds only its
    pair shard, so the shuffle happens per host, pre-packed); sub-epoch
    partitioning fuses per epoch via ``make_subepoch_epoch_fn``.

    Returns f(state, sampler_state, shuffle_keys (E,), epoch_keys (E,),
              lrs (E,), pairs (N, 2), his_items, his_masks)
        -> (state, sampler_state, loss_sums (E,))
    """
    d_ax = 1
    batch_sh = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from heat_cf.parallel.mesh import DATA_AXIS

        d_ax = mesh.shape[DATA_AXIS]
        # (num_batches, batch) arrays: split the batch dim over "data"
        # (parallel.mesh.batch_sharding's layout).
        batch_sh = NamedSharding(mesh, PartitionSpec(None, DATA_AXIS))

    def multi_epoch_fn(
        state,
        sampler_state,
        shuffle_keys,
        epoch_keys,
        lrs,
        pairs,
        his_items,
        his_masks,
    ):
        n = pairs.shape[0]
        batch = min(cfg.batch_size, max(1, n))
        batch = -(-batch // d_ax) * d_ax  # divisible by the data axis
        num_batches = -(-n // batch)
        total = num_batches * batch
        weight = (
            (jnp.arange(total) < n).astype(jnp.float32)
            .reshape(num_batches, batch)
        )
        if batch_sh is not None:
            weight = jax.lax.with_sharding_constraint(weight, batch_sh)

        def epoch_body(carry, xs):
            state, sampler_state = carry
            k_shuf, k_epoch, lr = xs
            state = state.replace(lr=lr)
            su, sp = shuffle_pairs(k_shuf, pairs, total)
            users = su.reshape(num_batches, batch)
            pos = sp.reshape(num_batches, batch)
            if batch_sh is not None:
                # Match the per-epoch path's host-side placement
                # (Engine._make_batches device_puts batches P(None, "data")):
                # each scanned (batch,) slice is split over the data axis.
                users = jax.lax.with_sharding_constraint(users, batch_sh)
                pos = jax.lax.with_sharding_constraint(pos, batch_sh)
            bkeys = jax.random.split(k_epoch, num_batches)
            user_means = _refresh_pools(cfg, state, his_items, his_masks)

            def body(c, bxs):
                st, ss = c
                k, u, p, w = bxs
                st, ss, loss = train_step(
                    st,
                    ss,
                    k,
                    Batch(u, p, w),
                    his_items,
                    his_masks,
                    cfg,
                    user_means=user_means,
                )
                return (st, ss), loss

            (state, sampler_state), losses = jax.lax.scan(
                body, (state, sampler_state), (bkeys, users, pos, weight)
            )
            if state.user_gacc is not None:
                # accum mode: grad tables zero at every (sub-)epoch end
                # (engine.cpp:345-347; matches train_one_epoch).
                from heat_cf.models.state import zero_grad_accumulators

                state = zero_grad_accumulators(state)
            return (state, sampler_state), jnp.sum(losses)

        (state, sampler_state), loss_sums = jax.lax.scan(
            epoch_body,
            (state, sampler_state),
            (shuffle_keys, epoch_keys, lrs),
        )
        return state, sampler_state, loss_sums

    return jax.jit(multi_epoch_fn, donate_argnums=(0, 1))


def make_subepoch_epoch_fn(cfg: CFConfig, mesh=None):
    """One device program for a FULL sub-epoch epoch: scan over the S
    sub-epoch buckets (each with its own packed batches and
    partition-complement negative pool), with accum-mode grad zeroing at
    every sub-epoch boundary — replacing S dispatches per epoch with one
    (the reference's live MPI mode is the sub-epoch scheme,
    engine.cpp:108-131), so the fixed per-dispatch cost is paid once per
    epoch rather than S times.

    Buckets are ragged: batches pad with weight-0 rows/batches and every
    complement pool pads to one static width with its true length in
    ``pool_sizes`` (draws index pool[draw % size], so padding never
    biases the sampling distribution — see train_step
    ``neg_candidates_size``).

    Returns f(state, sampler_state, epoch_keys (S,), users (S, nb, B),
              pos, weight, pools (S, C), pool_sizes (S,),
              his_items, his_masks)
        -> (state, sampler_state, loss_sum)
    """
    batch_sh = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from heat_cf.parallel.mesh import DATA_AXIS

        batch_sh = NamedSharding(mesh, PartitionSpec(None, None, DATA_AXIS))

    def subepoch_epoch_fn(
        state,
        sampler_state,
        epoch_keys,
        users,
        pos,
        weight,
        pools,
        pool_sizes,
        his_items,
        his_masks,
    ):
        num_batches = users.shape[1]
        if batch_sh is not None:
            users = jax.lax.with_sharding_constraint(users, batch_sh)
            pos = jax.lax.with_sharding_constraint(pos, batch_sh)
            weight = jax.lax.with_sharding_constraint(weight, batch_sh)

        # "global" scope (the accuracy-safe default — DESIGN.md 6g)
        # ignores the pool operands: negatives draw from the full item
        # space, same key stream (draw counts are scope-invariant).
        constrain = cfg.subepoch_neg_scope == "complement"

        def sub_body(carry, xs):
            state, sampler_state = carry
            k_epoch, s_users, s_pos, s_weight, pool, pool_size = xs
            bkeys = jax.random.split(k_epoch, num_batches)
            user_means = _refresh_pools(cfg, state, his_items, his_masks)

            def body(c, bxs):
                st, ss = c
                k, u, p, w = bxs
                st, ss, loss = train_step(
                    st,
                    ss,
                    k,
                    Batch(u, p, w),
                    his_items,
                    his_masks,
                    cfg,
                    neg_candidates=pool if constrain else None,
                    neg_candidates_size=pool_size if constrain else None,
                    user_means=user_means,
                )
                return (st, ss), loss

            (state, sampler_state), losses = jax.lax.scan(
                body, (state, sampler_state),
                (bkeys, s_users, s_pos, s_weight),
            )
            if state.user_gacc is not None:
                # Grad tables zero at EVERY sub-epoch end
                # (engine.cpp:345-347).
                from heat_cf.models.state import zero_grad_accumulators

                state = zero_grad_accumulators(state)
            return (state, sampler_state), jnp.sum(losses)

        (state, sampler_state), loss_sums = jax.lax.scan(
            sub_body,
            (state, sampler_state),
            (epoch_keys, users, pos, weight, pools, pool_sizes),
        )
        return state, sampler_state, jnp.sum(loss_sums)

    return jax.jit(subepoch_epoch_fn, donate_argnums=(0, 1))


def make_subepoch_epoch_fn_device(
    cfg: CFConfig, mesh, s_count: int, nb: int, batch: int
):
    """Jitted wrapper over :func:`make_subepoch_epoch_impl` (state and
    sampler state donated). See the impl's docstring for the program."""
    return jax.jit(
        make_subepoch_epoch_impl(cfg, mesh, s_count, nb, batch),
        donate_argnums=(0, 1),
    )


def make_subepoch_multi_epoch_fn(
    cfg: CFConfig, mesh, s_count: int, nb: int, batch: int
):
    """E sub-epoch epochs as ONE device program: an epochs-scan over the
    on-device-bucketed epoch (:func:`make_subepoch_epoch_impl`) — the
    ``--fused-epochs`` amortization for the reference's DEFAULT config
    shape (cf_config.py:7 combines tile_size with num_subepoches).
    Per-epoch host randomness (item permutations, bucket counts,
    per-bucket keys) rides in stacked, exactly as in the fused full-run
    program (train/run.make_run_fn_subepoch).

    Returns f(state, sampler_state, shuffle_keys (E, S), epoch_keys
              (E, S), lrs (E,), perms (E, I), counts (E, S),
              pairs (N, 2), his_items, his_masks)
        -> (state, sampler_state, loss_sums (E,))
    State and sampler state are donated.
    """
    epoch_impl = make_subepoch_epoch_impl(cfg, mesh, s_count, nb, batch)

    def multi_epoch_fn(
        state,
        sampler_state,
        shuffle_keys,
        epoch_keys,
        lrs,
        perms,
        counts,
        pairs,
        his_items,
        his_masks,
    ):
        def epoch_body(carry, xs):
            state, sampler_state = carry
            sk, ek, lr, perm, cnt = xs
            state = state.replace(lr=lr)
            state, sampler_state, loss_sum = epoch_impl(
                state, sampler_state, sk, ek, perm, cnt,
                pairs, his_items, his_masks,
            )
            return (state, sampler_state), loss_sum

        (state, sampler_state), loss_sums = jax.lax.scan(
            epoch_body,
            (state, sampler_state),
            (shuffle_keys, epoch_keys, lrs, perms, counts),
        )
        return state, sampler_state, loss_sums

    return jax.jit(multi_epoch_fn, donate_argnums=(0, 1))


def make_subepoch_epoch_impl(
    cfg: CFConfig, mesh, s_count: int, nb: int, batch: int
):
    """Sub-epoch epoch with ON-DEVICE bucketing: one device program, one
    tiny upload (the item permutation) per epoch. Returned UNJITTED so
    the fused full-run program (train/run.py) can inline it into an
    epochs-scan; ``make_subepoch_epoch_fn_device`` is the jitted form.

    The host-packed path (make_subepoch_epoch_fn) uploads every bucket's
    packed batches from the host each epoch. Here the program receives
    the raw (N, 2) pair table (already device-resident) plus the host-drawn item permutation (I int32 — the
    host rng keeps cross-host/per-bucket-oracle parity) and does the
    bucketing itself:

      1. part_of: scatter the static partition ids through the
         permutation (engine.cpp:108-121's col_map);
      2. pair_part = part_of[pos ids]; STABLE sort pairs by partition —
         buckets become contiguous runs in original pair order (exactly
         the host path's boolean-mask order);
      3. per sub-epoch: dynamic-slice a static (nb*batch)-row window at
         the bucket's start (pairs padded by one window so no clamp),
         shuffle it with the bucket's key exactly like
         _permute_batches_padded (same bits, same masked-tail sort —
         bit-identical real prefix), weight = arange < count;
      4. the usual batch scan with the partition-complement pool, which
         is computed on device from the permutation (static bounds).

    Key/count discipline matches the host path: the engine still computes
    per-bucket counts host-side (np.bincount — cheap; it sizes the static
    window too) and draws keys only for non-empty buckets.

    Returns f(state, sampler_state, shuffle_keys (S,), epoch_keys (S,),
              perm (I,), counts (S,), pairs (N, 2), his_items, his_masks)
        -> (state, sampler_state, loss_sum)
    """
    num_items = cfg.num_items
    bounds = [
        int(x)
        for x in __import__("numpy").linspace(0, num_items, s_count + 1)
    ]
    part_sizes = [bounds[s + 1] - bounds[s] for s in range(s_count)]
    pool_sizes_static = [num_items - p for p in part_sizes]
    c_max = max(1, max(pool_sizes_static))
    cap_rows = nb * batch
    batch_sh = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from heat_cf.parallel.mesh import DATA_AXIS

        batch_sh = NamedSharding(mesh, PartitionSpec(None, DATA_AXIS))

    def subepoch_epoch_fn(
        state,
        sampler_state,
        shuffle_keys,
        epoch_keys,
        perm,
        counts,
        pairs,
        his_items,
        his_masks,
    ):
        import numpy as _np

        # 1. partition assignment through the permutation.
        part_ids = jnp.asarray(
            _np.repeat(
                _np.arange(s_count, dtype=_np.int32), part_sizes
            )
        )
        part_of = (
            jnp.zeros((num_items,), jnp.int32).at[perm].set(part_ids)
        )
        pair_part = part_of[pairs[:, 1]]
        # 2. stable sort by partition: contiguous buckets, original order
        # within each (the host boolean-mask order).
        _, su_all, sp_all = jax.lax.sort(
            (pair_part, pairs[:, 0], pairs[:, 1]),
            dimension=0,
            num_keys=1,
            is_stable=True,
        )
        pad = jnp.zeros((cap_rows,), jnp.int32)
        su_all = jnp.concatenate([su_all, pad])
        sp_all = jnp.concatenate([sp_all, pad])
        starts = jnp.concatenate(
            [jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)]
        )[:-1]
        # 4's pool: complement of each partition in PERM order (static
        # bounds — identical to the host path's pools_np). Only built in
        # "complement" scope; the "global" default (DESIGN.md 6g) draws
        # negatives from the full item space with the same key stream.
        constrain = cfg.subepoch_neg_scope == "complement"
        if constrain:
            pools = jnp.stack(
                [
                    jnp.concatenate(
                        [perm[: bounds[s]], perm[bounds[s + 1] :]]
                        + (
                            [
                                jnp.broadcast_to(
                                    perm[:1],
                                    (c_max - pool_sizes_static[s],),
                                )
                            ]
                            if c_max > pool_sizes_static[s]
                            else []
                        )
                    )
                    for s in range(s_count)
                ]
            )
            pool_sizes = jnp.asarray(
                [max(1, p) for p in pool_sizes_static], jnp.int32
            )
        else:
            pools = jnp.zeros((s_count, 1), jnp.int32)
            pool_sizes = jnp.ones((s_count,), jnp.int32)

        def sub_body(carry, xs):
            state, sampler_state = carry
            k_shuffle, k_epoch, start, count, pool, pool_size = xs
            sl_u = jax.lax.dynamic_slice(su_all, (start,), (cap_rows,))
            sl_p = jax.lax.dynamic_slice(sp_all, (start,), (cap_rows,))
            real = jnp.arange(cap_rows, dtype=jnp.int32) < count
            if cfg.shuffle_mode == "none":
                bu, bp = sl_u, sl_p
            else:
                # Exactly _permute_batches_padded's shuffle: same bits,
                # real keys capped at 0xFFFFFFFE, tail (here: the NEXT
                # buckets' rows) masked to 0xFFFFFFFF and weighted out.
                bits = jax.random.bits(k_shuffle, (cap_rows,))
                bits = jnp.where(
                    jnp.logical_and(
                        real, bits == jnp.uint32(0xFFFFFFFF)
                    ),
                    jnp.uint32(0xFFFFFFFE),
                    bits,
                )
                bits = jnp.where(
                    real, bits, jnp.uint32(0xFFFFFFFF)
                )
                _, bu, bp = jax.lax.sort(
                    (bits, sl_u, sl_p), dimension=0, num_keys=1
                )
            users = bu.reshape(nb, batch)
            pos = bp.reshape(nb, batch)
            weight = real.astype(jnp.float32).reshape(nb, batch)
            if batch_sh is not None:
                users = jax.lax.with_sharding_constraint(users, batch_sh)
                pos = jax.lax.with_sharding_constraint(pos, batch_sh)
                weight = jax.lax.with_sharding_constraint(
                    weight, batch_sh
                )
            bkeys = jax.random.split(k_epoch, nb)
            user_means = _refresh_pools(cfg, state, his_items, his_masks)

            def body(c, bxs):
                st, ss = c
                k, u, p, w = bxs
                st, ss, loss = train_step(
                    st, ss, k, Batch(u, p, w), his_items, his_masks, cfg,
                    neg_candidates=pool if constrain else None,
                    neg_candidates_size=(
                        pool_size if constrain else None
                    ),
                    user_means=user_means,
                )
                return (st, ss), loss

            (state, sampler_state), losses = jax.lax.scan(
                body, (state, sampler_state), (bkeys, users, pos, weight)
            )
            if state.user_gacc is not None:
                from heat_cf.models.state import zero_grad_accumulators

                state = zero_grad_accumulators(state)
            return (state, sampler_state), jnp.sum(losses)

        (state, sampler_state), loss_sums = jax.lax.scan(
            sub_body,
            (state, sampler_state),
            (
                shuffle_keys,
                epoch_keys,
                starts.astype(jnp.int32),
                counts.astype(jnp.int32),
                pools,
                pool_sizes,
            ),
        )
        return state, sampler_state, jnp.sum(loss_sums)

    return subepoch_epoch_fn


def make_multi_epoch_stream_fn(cfg: CFConfig, mesh=None):
    """Fused multi-epoch program consuming PRE-PACKED per-epoch batch
    streams: users/pos/weight carry a leading epoch axis (E, nb, B) and the
    epoch scan reads each epoch's batches from its xs. This is the
    multi-host fused path for cfg.shuffle_mode == "epoch": each host
    shuffles+packs its LOCAL pairs for all E epochs up front (the on-device global shuffle of ``make_multi_epoch_fn`` cannot
    see per-host pair shards), the global (E, nb, B) arrays are assembled
    once, and E epochs run as ONE device program — the reference's actual
    deployment shape (mpirun, cf/main.py:106-114) with the single-device
    best-path dispatch count.

    Returns f(state, sampler_state, epoch_keys (E,), lrs (E,),
              users (E, nb, B), pos, weight, his_items, his_masks)
        -> (state, sampler_state, loss_sums (E,))
    """
    batch_sh = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from heat_cf.parallel.mesh import DATA_AXIS

        batch_sh = NamedSharding(mesh, PartitionSpec(None, None, DATA_AXIS))

    def multi_epoch_stream_fn(
        state,
        sampler_state,
        epoch_keys,
        lrs,
        users,
        pos,
        weight,
        his_items,
        his_masks,
    ):
        num_batches = users.shape[1]
        if batch_sh is not None:
            users = jax.lax.with_sharding_constraint(users, batch_sh)
            pos = jax.lax.with_sharding_constraint(pos, batch_sh)
            weight = jax.lax.with_sharding_constraint(weight, batch_sh)

        def epoch_body(carry, xs):
            state, sampler_state = carry
            k_epoch, lr, e_users, e_pos, e_weight = xs
            state = state.replace(lr=lr)
            bkeys = jax.random.split(k_epoch, num_batches)
            user_means = _refresh_pools(cfg, state, his_items, his_masks)

            def body(c, bxs):
                st, ss = c
                k, u, p, w = bxs
                st, ss, loss = train_step(
                    st,
                    ss,
                    k,
                    Batch(u, p, w),
                    his_items,
                    his_masks,
                    cfg,
                    user_means=user_means,
                )
                return (st, ss), loss

            (state, sampler_state), losses = jax.lax.scan(
                body, (state, sampler_state), (bkeys, e_users, e_pos, e_weight)
            )
            if state.user_gacc is not None:
                # accum mode: grad tables zero at every (sub-)epoch end
                # (engine.cpp:345-347; matches train_one_epoch).
                from heat_cf.models.state import zero_grad_accumulators

                state = zero_grad_accumulators(state)
            return (state, sampler_state), jnp.sum(losses)

        (state, sampler_state), loss_sums = jax.lax.scan(
            epoch_body,
            (state, sampler_state),
            (epoch_keys, lrs, users, pos, weight),
        )
        return state, sampler_state, loss_sums

    return jax.jit(multi_epoch_stream_fn, donate_argnums=(0, 1))


def make_multi_epoch_fixed_fn(cfg: CFConfig, mesh=None):
    """Fused multi-epoch program for FIXED batch streams (cfg.shuffle_mode
    "none"/"once"): the packed (nb, B) batches are inputs reused by every
    epoch — no on-device shuffle — and the history-gather dedup maps
    (train_step uniq_users path) ride along when provided. This gives the
    live-visit-order exact mode (parse-order streams, engine.cpp:243-252)
    the same one-dispatch-per-E-epochs shape as the shuffled headline.

    Returns f(state, sampler_state, epoch_keys (E,), lrs (E,),
              users (nb, B), pos, weight, his_items, his_masks
              [, uniq_users (nb, Bu), uniq_inverse (nb, B)])
        -> (state, sampler_state, loss_sums (E,))
    """
    batch_sh = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from heat_cf.parallel.mesh import DATA_AXIS

        batch_sh = NamedSharding(mesh, PartitionSpec(None, DATA_AXIS))

    def multi_epoch_fixed_fn(
        state,
        sampler_state,
        epoch_keys,
        lrs,
        users,
        pos,
        weight,
        his_items,
        his_masks,
        uniq_users=None,
        uniq_inverse=None,
        uniq_first=None,
    ):
        num_batches = users.shape[0]
        if batch_sh is not None:
            users = jax.lax.with_sharding_constraint(users, batch_sh)
            pos = jax.lax.with_sharding_constraint(pos, batch_sh)
            weight = jax.lax.with_sharding_constraint(weight, batch_sh)
        have_uniq = uniq_users is not None
        have_first = have_uniq and uniq_first is not None

        def epoch_body(carry, xs):
            state, sampler_state = carry
            k_epoch, lr = xs
            state = state.replace(lr=lr)
            bkeys = jax.random.split(k_epoch, num_batches)
            user_means = _refresh_pools(cfg, state, his_items, his_masks)

            def body(c, bxs):
                st, ss = c
                uf = None
                if have_first:
                    k, u, p, w, uu, ui, uf = bxs
                elif have_uniq:
                    k, u, p, w, uu, ui = bxs
                else:
                    k, u, p, w = bxs
                    uu = ui = None
                st, ss, loss = train_step(
                    st,
                    ss,
                    k,
                    Batch(u, p, w),
                    his_items,
                    his_masks,
                    cfg,
                    user_means=user_means,
                    uniq_users=uu,
                    uniq_inverse=ui,
                    uniq_first=uf,
                )
                return (st, ss), loss

            bxs = (bkeys, users, pos, weight)
            if have_uniq:
                bxs = bxs + (uniq_users, uniq_inverse)
            if have_first:
                bxs = bxs + (uniq_first,)
            (state, sampler_state), losses = jax.lax.scan(
                body, (state, sampler_state), bxs
            )
            if state.user_gacc is not None:
                # accum mode: grad tables zero at every (sub-)epoch end
                # (engine.cpp:345-347; matches train_one_epoch).
                from heat_cf.models.state import zero_grad_accumulators

                state = zero_grad_accumulators(state)
            return (state, sampler_state), jnp.sum(losses)

        (state, sampler_state), loss_sums = jax.lax.scan(
            epoch_body, (state, sampler_state), (epoch_keys, lrs)
        )
        return state, sampler_state, loss_sums

    return jax.jit(multi_epoch_fixed_fn, donate_argnums=(0, 1))
