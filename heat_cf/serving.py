"""Inference/serving: top-k recommendations from a trained model.

The reference has no inference path beyond its evaluation matrix; this
module rounds out the framework for deployment: load a checkpoint (or take
a live TrainState), optionally apply fresh behavior aggregation to user
embeddings, and serve batched top-k item recommendations with
already-interacted items masked — all on device via the tiled evaluator.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from heat_cf.config import CFConfig
from heat_cf.evaluation.evaluator import (
    NEG_INF,
    TiledEvaluator,
    masked_topk,
    pad_bits_words,
)
from heat_cf.models.aggregator import (
    aggregate_history,
    history_mean_fused,
    pool_history,
)
from heat_cf.models.state import TrainState


@functools.partial(jax.jit, static_argnames=("k",))
def _topk_request(user_rows, item_pad, bits_rows, k: int):
    """Rank ONE request batch: (B, d) user rows against the (padded)
    item table with per-row packed seen-masks — the serving hot path
    (scoring only the requested rows; ``recommend_all`` ranks the whole
    user table regardless of request size)."""
    sim = jnp.dot(
        user_rows.astype(jnp.float32),
        item_pad.astype(jnp.float32).T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    _, ids = masked_topk(sim, bits_rows, k)
    return ids


# Above this many (padded) item rows the one-shot request path's
# (B, W, 32) mask-unpack relayout of the whole (B, I) score matrix
# dominates, so the chunked path below processes the item axis in chunks
# with a running top-k merge instead. Below it (AmazonBooks-class tables,
# 91.6k items) the one-shot path needs one program and no merge. The
# threshold was chosen on the previous accelerator and is not re-derived
# on the GPU yet.
_CHUNKED_REQUEST_MIN_ITEMS = 262_144
# Chunk-pad multiple: the item table and mask width are padded once (at
# construction) to a multiple of this, so every power-of-two chunk size
# <= it divides the padded item count evenly.
_REQUEST_PAD_MULTIPLE = 262_144


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def _topk_request_chunked(user_rows, item_pad, bits_rows, k: int, chunk: int):
    """Huge-item-table request ranking: scan the item axis in ``chunk``-row
    slices, each scored + packed-mask-selected like the one-shot path,
    with a running (B, k) best merged per chunk. Exact: every chunk's
    top-k is exact, and a global top-k element is necessarily its
    chunk's top-k element, so the merge loses nothing. ``item_pad`` rows
    and ``bits_rows`` width must be pre-padded to a multiple of ``chunk``
    with PAD BITS SET (the constructor's ``_REQUEST_PAD_MULTIPLE``
    padding), so pad rows never rank."""
    b = user_rows.shape[0]
    n_chunks = item_pad.shape[0] // chunk
    w = chunk // 32
    rows32 = user_rows.astype(jnp.float32)
    items = item_pad.reshape(n_chunks, chunk, item_pad.shape[1])
    bits = bits_rows.reshape(b, n_chunks, w).transpose(1, 0, 2)
    offs = jnp.arange(n_chunks, dtype=jnp.int32) * jnp.int32(chunk)

    def step(carry, xs):
        best_v, best_i = carry
        item_c, bits_c, off = xs
        sim = jnp.dot(
            rows32,
            item_c.astype(jnp.float32).T,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        v, i = masked_topk(sim, bits_c, k)
        cv = jnp.concatenate([best_v, v], axis=1)
        ci = jnp.concatenate([best_i, i.astype(jnp.int32) + off], axis=1)
        mv, mpos = jax.lax.top_k(cv, k)
        return (mv, jnp.take_along_axis(ci, mpos, axis=1)), None

    init = (
        jnp.full((b, k), NEG_INF, jnp.float32),
        jnp.zeros((b, k), jnp.int32),
    )
    (_, ids), _ = jax.lax.scan(step, init, (items, bits, offs))
    return ids


def _gathered(x):
    """A host-usable view of a (possibly multi-host-sharded) array: arrays
    that are not fully addressable on this process (live multi-host engine
    state) are allgathered to every host; everything else passes through.
    The same machinery export_embeddings uses (export.py)."""
    if x is None:
        return None
    if getattr(x, "is_fully_addressable", True) is False:
        from jax.experimental import multihost_utils

        # jnp, not the allgather's host numpy: serving's jitted paths
        # index these tables with traced ids.
        return jnp.asarray(multihost_utils.process_allgather(x, tiled=True))
    return x


class Recommender:
    """Batched top-k recommendation over a trained model.

    Args:
      state: trained TrainState (e.g. ``engine.state`` or a checkpoint
        restore).
      cfg: the training config (for gamma / aggregation).
      seen_pairs: (N, 2) user-item interactions to exclude from results
        (typically the training clicks), or None.
      his_items / his_masks: user history arrays; required only for
        ``aggregate_users=True`` recommendation.

    Serving contract for LIVE engine states: construct via
    :meth:`from_engine` — it slices off mesh-divisibility padding rows
    (single-process meshes) and allgathers multi-host table shards so
    every host can serve the full user space; passing a raw multi-host
    ``engine.state`` here directly would index non-addressable arrays.
    """

    def __init__(
        self,
        state: TrainState,
        cfg: CFConfig,
        seen_pairs: Optional[np.ndarray] = None,
        his_items=None,
        his_masks=None,
        user_tile: int = 512,
    ):
        self.state = state
        self.cfg = cfg
        self.his_items = his_items
        self.his_masks = his_masks
        self._evaluator = TiledEvaluator(
            seen_pairs,
            int(state.user_emb.shape[0]),
            user_tile=user_tile,
            # Pin the true item count: inferring it from seen_pairs (its
            # default) under-sizes the packed mask whenever the highest
            # seen item id sits well below the table's row count, which
            # would shape-mismatch the request path's bitmask unpack.
            num_items=int(state.item_emb.shape[0]),
        )
        # Request-path caches: the packed seen-mask as a flat per-user-row
        # bitmap and the item table with its axis padded to the mask width
        # (zero rows; pad bits are hard-masked) — built once, so a
        # recommend() call moves only (B,) ids in and (B, k) ids out.
        ev = self._evaluator
        self._bits_flat = (
            None
            if ev.mask_bits is None
            else ev.mask_bits.reshape(-1, ev.mask_bits.shape[2])
        )
        item_emb = state.item_emb
        pad = ev._pad_items - int(item_emb.shape[0])
        if pad > 0:
            item_emb = jnp.concatenate(
                [
                    item_emb,
                    jnp.zeros((pad, item_emb.shape[1]), item_emb.dtype),
                ]
            )
        self._item_pad = item_emb
        # Huge item tables: chunk-pad the request-path arrays ONCE so the
        # chunked scan (_topk_request_chunked) divides evenly. Pad rows
        # are zero embeddings with their mask bits SET, so they never
        # rank — same contract as the evaluator's item-axis padding.
        self._chunked_request = (
            int(self._item_pad.shape[0]) >= _CHUNKED_REQUEST_MIN_ITEMS
        )
        self._pad_bits_row = None
        self._seen_indptr = self._seen_keys = None
        if self._chunked_request:
            n_real = int(state.item_emb.shape[0])
            i0 = int(self._item_pad.shape[0])
            ic = -(-i0 // _REQUEST_PAD_MULTIPLE) * _REQUEST_PAD_MULTIPLE
            if ic > i0:
                self._item_pad = jnp.concatenate(
                    [
                        self._item_pad,
                        jnp.zeros(
                            (ic - i0, self._item_pad.shape[1]),
                            self._item_pad.dtype,
                        ),
                    ]
                )
                if self._bits_flat is not None:
                    self._bits_flat = jnp.concatenate(
                        [
                            self._bits_flat,
                            jnp.full(
                                (self._bits_flat.shape[0], (ic - i0) // 32),
                                0xFFFFFFFF,
                                self._bits_flat.dtype,
                            ),
                        ],
                        axis=1,
                    )
            if self._bits_flat is None:
                # The full (U, I/32) bitmap exceeded the packed budget
                # (production geometries: 6M items puts it at GBs) — the
                # request path instead retrieves top-(k + cap) UNMASKED
                # and drops seen items host-side (exact: at most cap of
                # the retrieved can be seen). Pad/eval-pad rows are the
                # only device-side masking needed, and those bits are
                # identical for every row — one (W,) word row broadcast.
                w = (ic if ic > i0 else i0) // 32
                self._pad_bits_row = jnp.asarray(
                    pad_bits_words(n_real, w * 32, w)
                )
                if seen_pairs is not None and len(seen_pairs):
                    sp = np.asarray(seen_pairs, np.int64)
                    su = np.sort(sp[:, 0])
                    num_users = int(state.user_emb.shape[0])
                    # Per-user seen counts (for the retrieve-depth cap)
                    # + sorted (u, i) keys (for the vectorized filter).
                    self._seen_indptr = np.searchsorted(
                        su, np.arange(num_users + 1)
                    )
                    kmul = np.int64(self._item_pad.shape[0])
                    self._seen_keys = np.sort(sp[:, 0] * kmul + sp[:, 1])
        # Device copies of the history arrays, uploaded ONCE (a per-call
        # jnp.asarray of a numpy (U, H) table would re-upload ~21 MB per
        # aggregated request at AmazonBooks scale).
        self._his_dev = None if his_items is None else jnp.asarray(his_items)
        self._masks_dev = None if his_masks is None else jnp.asarray(his_masks)

    @classmethod
    def from_engine(
        cls,
        engine,
        seen_pairs: Optional[np.ndarray] = None,
        his_items=None,
        his_masks=None,
        user_tile: int = 512,
    ) -> "Recommender":
        """Serve from a LIVE engine — single-process, mesh-sharded, or
        multi-host.

        Handles the two live-state layouts a raw ``Recommender(state=...)``
        cannot: single-process mesh engines pad table rows for GSPMD
        divisibility (``engine.unpadded_state()`` slices the pads off so
        row ids stay entity ids), and multi-host engines hold only each
        process's table shards (the shards are allgathered to every host
        — the machinery ``export_embeddings`` uses — so every host serves
        the FULL user space; request results are identical across hosts
        and to a single-process Recommender on the gathered state, tested
        in ``scripts/multihost_demo.py --variant serve``).

        ``seen_pairs`` defaults to the engine's train pairs. NOTE for
        multi-host: each process's ``train_data`` is its user-range shard,
        so the default masks only local users' seen items — pass the full
        global pair list (every host parses the full click file in this
        architecture, datasets.shard_by_user_range) to serve all users
        with full masking. Same for ``his_items``/``his_masks`` when
        using ``aggregate_users``.
        """
        state = engine.unpadded_state()
        state = state.replace(
            user_emb=_gathered(state.user_emb),
            item_emb=_gathered(state.item_emb),
            w0=_gathered(state.w0),
            attn_q=_gathered(state.attn_q),
            user_gacc=None,
            item_gacc=None,
            opt_slots=None,
        )
        if seen_pairs is None:
            seen_pairs = np.asarray(engine.train_data.pairs)
        if his_items is None and not engine._multiprocess:
            his_items = engine.train_data.his_items
            his_masks = engine.train_data.masks
        return cls(
            state,
            engine.cfg,
            seen_pairs=seen_pairs,
            his_items=his_items,
            his_masks=his_masks,
            user_tile=user_tile,
        )

    def _user_embeddings(self, aggregate_users: bool):
        user_emb = self.state.user_emb
        if not aggregate_users:
            return user_emb
        if self.his_items is None or self.his_masks is None:
            raise ValueError("aggregate_users requires history arrays")
        from heat_cf.train.engine import compute_user_pools

        pooled = compute_user_pools(
            self.state.item_emb,
            jnp.asarray(self.his_items),
            jnp.asarray(self.his_masks),
            user_emb=(
                user_emb
                if self.cfg.aggregator == "user_attention"
                else None
            ),
            attn_q=self.state.attn_q,
            aggregator=self.cfg.aggregator,
            max_his=self.cfg.max_his,  # history may be Engine's flat layout
            logical_dim=(
                self.cfg.emb_dim if self.cfg.emb_pad else None
            ),
        )
        return aggregate_history(
            user_emb, pooled, self.state.w0, self.cfg.gamma
        )

    def recommend_all(
        self, k: int, aggregate_users: bool = False
    ) -> np.ndarray:
        """(U, k) top item ids for every user."""
        _, ids = self._evaluator.topk(
            self._user_embeddings(aggregate_users), self.state.item_emb, k
        )
        return ids

    def _user_rows(self, uids: jnp.ndarray, aggregate_users: bool):
        """(B, d) embeddings for the requested users only. Pooling, when
        asked for, runs over just their histories — not the whole table —
        with the SAME numerics as the whole-table path
        (``compute_user_pools``): the chunk-fused mean and f32 attention
        logits, so a request's ranking matches ``recommend_all``'s."""
        u = self.state.user_emb[uids]
        if not aggregate_users:
            return u
        if self._his_dev is None or self._masks_dev is None:
            raise ValueError("aggregate_users requires history arrays")
        his = self._his_dev
        if his.ndim == 1:  # Engine's flat (U*H,) layout
            h = self.cfg.max_his
            hids = his[
                uids[:, None] * h + jnp.arange(h, dtype=uids.dtype)[None, :]
            ]
        else:
            hids = his[uids]
        masks = self._masks_dev[uids]
        if self.cfg.aggregator == "mean":
            pooled = history_mean_fused(self.state.item_emb, hids, masks)
        else:
            pooled = pool_history(
                self.state.item_emb[hids],
                masks,
                u=u,
                attn_q=self.state.attn_q,  # f32 logits, like the pools path
                kind=self.cfg.aggregator,
                logical_dim=(
                    self.cfg.emb_dim if self.cfg.emb_pad else None
                ),
            )
        return aggregate_history(u, pooled, self.state.w0, self.cfg.gamma)

    def recommend(
        self,
        user_ids: Sequence[int],
        k: int,
        aggregate_users: bool = False,
    ) -> np.ndarray:
        """(len(user_ids), k) top item ids for the requested users.

        Scores ONLY the requested rows (one (B, I) GEMM + per-row packed
        seen-mask + exact top-k; request batches pad to power-of-two
        buckets to bound jit specializations). Huge item tables
        (>= _CHUNKED_REQUEST_MIN_ITEMS rows) scan the item axis in
        chunks with a running top-k merge; when the per-user packed
        bitmap exceeds its budget they retrieve top-(k + cap) unmasked
        and drop seen items host-side (exact — DESIGN.md 6j). Small
        tables without any packed bitmap fall back to slicing
        ``recommend_all``."""
        uids_np = np.asarray(user_ids, np.int64)
        if uids_np.size == 0:
            return np.zeros((0, k), np.int32)
        num_users = int(self.state.user_emb.shape[0])
        if uids_np.min() < 0 or uids_np.max() >= num_users:
            # jnp gathers silently CLAMP out-of-range ids (which would
            # return another user's recommendations); match numpy-indexing
            # behavior instead.
            raise IndexError(
                f"user ids must be in [0, {num_users}); got range "
                f"[{uids_np.min()}, {uids_np.max()}]"
            )
        b = int(uids_np.size)
        bpad = max(8, 1 << (b - 1).bit_length())
        k2 = 0
        if self._bits_flat is None:
            # No-bitmap routing guards run BEFORE the per-request row
            # gather/pooling — every fallback below discards the rows.
            if not self._chunked_request:
                ids = self.recommend_all(k, aggregate_users=aggregate_users)
                return ids[uids_np]
            if 2 * bpad >= num_users:
                # A request covering most of the user table is the
                # whole-table ranking — the tiled evaluator amortizes
                # better per user there; the chunked path is for
                # requests that are a small slice of the users, the
                # production serving shape.
                ids = self.recommend_all(k, aggregate_users=aggregate_users)
                return ids[uids_np]
            cap = 0
            if self._seen_indptr is not None:
                counts = (
                    self._seen_indptr[uids_np + 1]
                    - self._seen_indptr[uids_np]
                )
                cap = int(counts.max()) if counts.size else 0
            # Round the retrieve depth to a multiple of 64 to bound jit
            # specializations across requests with different caps.
            k2 = -(-(k + cap) // 64) * 64
            if k2 > 4096:
                # Pathological: a requested user has thousands of seen
                # items; the retrieve-depth guarantee would need a
                # top-k wider than the chunk machinery is tuned for.
                # Rank the whole table instead (correct, just slower).
                ids = self.recommend_all(k, aggregate_users=aggregate_users)
                return ids[uids_np]
        uids = jnp.asarray(uids_np, jnp.int32)
        rows = self._user_rows(uids, aggregate_users)
        if bpad != b:
            rows = jnp.concatenate(
                [rows, jnp.zeros((bpad - b, rows.shape[1]), rows.dtype)]
            )
        if self._bits_flat is not None:
            bits = self._bits_flat[uids]
            if bpad != b:
                bits = jnp.concatenate(
                    [bits, jnp.zeros((bpad - b, bits.shape[1]), bits.dtype)]
                )
            if self._chunked_request:
                # Chunk the item axis (the one-shot (B, I) mask-unpack
                # relayout is the cost, DESIGN.md 6j). Chunk shrinks
                # with the request batch to bound the per-chunk
                # (B, chunk) score buffer at ~256 MB.
                ids = _topk_request_chunked(
                    rows, self._item_pad, bits, k, self._request_chunk(bpad)
                )
            else:
                ids = _topk_request(rows, self._item_pad, bits, k)
            return np.asarray(ids[:b]).astype(np.int32)
        # Huge item table WITHOUT a packed per-user bitmap (it exceeded
        # MASK_BITS_MAX_BYTES): retrieve top-(k + cap) unmasked — cap =
        # the largest seen-count among the requested users (folded into
        # k2 by the guard block above), so after dropping seen items
        # every row still has >= k survivors, so the result is exact
        # (DESIGN.md 6j).
        bits = jnp.broadcast_to(
            self._pad_bits_row[None, :],
            (bpad, int(self._pad_bits_row.shape[0])),
        )
        ids2 = _topk_request_chunked(
            rows, self._item_pad, bits, k2, self._request_chunk(bpad)
        )
        ids2 = np.asarray(ids2[:b]).astype(np.int64)
        if self._seen_keys is None:
            return ids2[:, :k].astype(np.int32)
        kmul = np.int64(self._item_pad.shape[0])
        keys = uids_np[:, None] * kmul + ids2
        pos = np.searchsorted(self._seen_keys, keys)
        found = (pos < len(self._seen_keys)) & (
            self._seen_keys[np.minimum(pos, len(self._seen_keys) - 1)]
            == keys
        )
        # Stable-select the first k unseen ids per row: argsort of the
        # seen flag (False first) preserves rank order within each class.
        order = np.argsort(found, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(ids2, order, axis=1).astype(np.int32)

    @staticmethod
    def _request_chunk(bpad: int) -> int:
        """Item-axis chunk for _topk_request_chunked: starts at the pad
        multiple and halves until the (B, chunk) score buffer is
        ~256 MB, floored at 32768 rows (always divides the chunk-padded
        item count — both are powers of two times the multiple)."""
        chunk = _REQUEST_PAD_MULTIPLE
        while chunk * bpad > (1 << 26) and chunk > 32_768:
            chunk //= 2
        return chunk

    def recommend_cold(
        self,
        histories: Sequence[Sequence[int]],
        k: int,
        exclude_history: bool = True,
    ) -> np.ndarray:
        """(len(histories), k) top item ids for UNSEEN users.

        A cold user has no trained embedding row; SimpleX's behavior
        aggregation provides a pure-history user vector,
        ``u = (1 - gamma) * pool(history) @ w0`` (the ``gamma * u`` blend
        term vanishes without a trained row). Pooling follows
        cfg.aggregator; ``user_attention`` uses the history mean as the
        query since there is no user row to attend with. Scoring is cosine
        against the item table; the provided history is masked out when
        ``exclude_history``.
        """
        n = len(histories)
        if n == 0:
            return np.zeros((0, k), np.int32)
        h = max(1, max(len(hist) for hist in histories))
        ids = np.zeros((n, h), np.int32)
        masks = np.zeros((n,), np.int32)
        for i, hist in enumerate(histories):
            hist = np.asarray(hist, np.int32)
            ids[i, : len(hist)] = hist
            masks[i] = len(hist)
        item_emb = self.state.item_emb
        compute = item_emb.dtype
        his_embs = item_emb[jnp.asarray(ids)]
        masks_j = jnp.asarray(masks)
        ld = self.cfg.emb_dim if self.cfg.emb_pad else None
        if self.cfg.aggregator == "user_attention":
            query = pool_history(his_embs, masks_j, kind="mean")
            pooled = pool_history(
                his_embs, masks_j, u=query, kind="user_attention",
                logical_dim=ld,
            )
        else:
            pooled = pool_history(
                his_embs,
                masks_j,
                attn_q=(
                    None
                    if self.state.attn_q is None
                    else self.state.attn_q.astype(compute)
                ),
                kind=self.cfg.aggregator,
                logical_dim=ld,
            )
        # HIGHEST, like every f32 product that feeds a ranking: at
        # default precision the GPU runs f32 matmuls in TF32.
        u = (1.0 - self.cfg.gamma) * jnp.dot(
            pooled,
            self.state.w0.astype(compute),
            precision=jax.lax.Precision.HIGHEST,
        )
        u = u / jnp.maximum(
            jnp.linalg.norm(u.astype(jnp.float32), axis=1, keepdims=True),
            1e-12,
        ).astype(compute)
        it = item_emb / jnp.maximum(
            jnp.linalg.norm(
                item_emb.astype(jnp.float32), axis=1, keepdims=True
            ),
            1e-12,
        ).astype(compute)
        # HIGHEST: no-op for bf16 compute; keeps f32 serving scores at f32
        # fidelity (the GPU's default runs f32 matmuls in TF32).
        sims = jnp.dot(
            u, it.T, precision=jax.lax.Precision.HIGHEST
        ).astype(jnp.float32)  # (n, I)
        if exclude_history:
            rows = jnp.repeat(jnp.arange(n, dtype=jnp.int32), h)
            cols = jnp.asarray(ids).reshape(-1)
            pos = jnp.arange(h, dtype=jnp.int32)[None, :].repeat(n, 0).reshape(-1)
            valid = pos < masks_j[rows]
            cols = jnp.where(valid, cols, item_emb.shape[0])  # drop padding
            # finfo.min, not -inf: the two-phase top-k's one-hot matmul
            # needs finite scores.
            sims = sims.at[rows, cols].set(
                jnp.finfo(jnp.float32).min, mode="drop"
            )
        _, top = masked_topk(sims, None, k)
        return np.asarray(top)
