"""On-device tiled top-k evaluation.

The reference evaluator materializes the full user x item similarity matrix
with one Eigen GEMM (engine.cpp:388-400), copies it to Python, masks train
items to -inf in numpy, and top-ks with argpartition (metrics.py:21-29). At
full scale that matrix does not fit anywhere (52k x 91k f32 ~ 19 GB; the
synthetic 100M x 10M config makes it absurd), so here the evaluation runs in
user tiles entirely on device, as ONE jitted scan over tiles (per-tile
dispatch round-trips dominate otherwise):

  scan over user tiles:
      sim   = U_tile @ I^T            (GEMM, f32 accumulation)
      sim  -= inf at this tile's train pairs (scatter, padded ids dropped)
      top_k = exact top-k of sim      (exact_topk_2phase or lax.top_k)

Only (num_users, k) scores/ids ever reach the host. Evaluation scoring uses
the raw dot product, as the reference does (engine.cpp:398 — no
normalization in evaluate0, unlike training's cosine).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = jnp.finfo(jnp.float32).min

# Window width for the two-phase exact top-k.
_TOPK_WINDOW = 128
# Below this many items a single lax.top_k is used instead of two phases
# (crossover chosen on the previous accelerator; not re-derived on the GPU).
_TOPK_2PHASE_MIN_ITEMS = 4 * 1024


def masked_topk(
    sim: jnp.ndarray,
    bits,
    k: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Shared packed-bitmask masking + exact top-k selection.

    bits: (B, W) u32 packed mask (set bits score NEG_INF; ``sim`` must be
    (B, W*32)), or None for pre-masked scores. Selection is the two-phase
    exact top-k above _TOPK_2PHASE_MIN_ITEMS, ``lax.top_k`` below. Used by
    the tiled evaluator, the shard_map distributed top-k, and serving's
    request path — one place for the mask/selection lessons.
    """
    if bits is not None:
        rows, w = sim.shape[0], bits.shape[1]
        shifts = jnp.arange(32, dtype=jnp.uint32)
        simp = sim.reshape(rows, w, 32)
        sim = jnp.where(
            (bits[:, :, None] >> shifts) & 1 == 1, NEG_INF, simp
        ).reshape(rows, w * 32)
    if sim.shape[1] >= _TOPK_2PHASE_MIN_ITEMS:
        return exact_topk_2phase(sim, k)
    return jax.lax.top_k(sim, k)


def exact_topk_2phase(
    sim: jnp.ndarray, k: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact top-k via window-max pre-selection — one sort-free reduction
    pass plus two NARROW top-ks, instead of one sort-bound top-k over the
    full row (which of the two is faster on the GPU is not measured yet).

    Exactness argument: let tau be the k-th largest element of a row.
    Every window containing a top-k element has max >= tau, and any window
    with max >= tau contains an element >= tau — of which there are
    exactly k (modulo ties at tau) — so AT MOST k windows have
    max >= tau. The top-k windows by max therefore contain every top-k
    element; an exact top-k over those k*W candidates finishes the job.

    Tie semantics: with duplicates equal to tau the returned set is a
    valid top-k but may resolve ties differently than ``lax.top_k``'s
    lowest-index rule.

    Args:
      sim: (B, I) scores (rows independent).
      k: ranks to return.

    Returns:
      (scores, ids): both (B, k), sorted descending.
    """
    b, n = sim.shape
    w = _TOPK_WINDOW
    nw = -(-n // w)
    pad = nw * w - n
    if pad:
        sim = jnp.concatenate(
            [sim, jnp.full((b, pad), NEG_INF, sim.dtype)], axis=1
        )
    sim3 = sim.reshape(b, nw, w)
    wmax = jnp.max(sim3, axis=2)  # (B, nw)
    kw = min(k, nw)
    if nw >= _TOPK_2PHASE_MIN_ITEMS:
        # Recurse: at millions of items (6M -> 47k windows) the window-max
        # top-k is itself sort-bound. Exactness is inductive.
        _, widx = exact_topk_2phase(wmax, kw)
    else:
        _, widx = jax.lax.top_k(wmax, kw)  # (B, kw)
    # Candidate extraction as a batched one-hot matmul
    # (B, kw, nw) x (B, nw, w) instead of a per-(row, window) gather.
    # Exact because each output sums exactly one finite score (masking
    # uses finfo.min, never -inf, so the 0 * masked terms vanish).
    # Precision MUST be HIGHEST: at default precision a GPU runs an f32
    # matmul in TF32 (10 mantissa bits), which rounds the extracted scores
    # and silently re-ranks candidates whose scores differ below TF32
    # resolution. CPU tests never see it because CPU matmuls are exact f32.
    onehot = (
        widx[:, :, None] == jnp.arange(nw, dtype=widx.dtype)[None, None, :]
    ).astype(sim.dtype)
    cand = jnp.einsum(
        "bkn,bnw->bkw",
        onehot,
        sim3,
        preferred_element_type=sim.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    scores, local = jax.lax.top_k(cand.reshape(b, kw * w), k)
    ids = (
        jnp.take_along_axis(widx, local // w, axis=1) * w + local % w
    )
    return scores, ids


def topk_all_tiles_impl(
    user_tiles: jnp.ndarray,  # (n_tiles, T, d)
    item_emb: jnp.ndarray,    # (I_pad, d) — item axis padded to a 128 multiple
    mask_u: jnp.ndarray,      # (n_tiles, P) tile-local user rows (>=T drops)
    mask_i: jnp.ndarray,      # (n_tiles, P) item ids
    mask_bits: jnp.ndarray | None,  # (n_tiles, T, I_pad/32) u32, or None
    *,
    k: int,
    valid_items: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Traceable core of the tiled top-k (see module docstring): callers
    inside larger jitted programs (the fused train→eval run program,
    train/run.py) inline this; standalone use goes through the jitted
    wrapper ``_topk_all_tiles``."""
    item_t = item_emb.astype(jnp.float32).T
    num_items = item_emb.shape[0]
    if valid_items is None:
        valid_items = num_items

    def body(carry, xs):
        u_tile, mu, mi, bits = xs
        # HIGHEST: at default precision the GPU runs this f32 GEMM in
        # TF32, so f32 tables would score at 10-bit-mantissa fidelity,
        # unlike the reference's f32 GEMM (engine.cpp:398), and the
        # ranking would reorder near-ties.
        sim = jnp.dot(
            u_tile.astype(jnp.float32),
            item_t,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        if bits is None:
            # Generic path: per-pair scatter (the bitmask path below is
            # preferred: one fused elementwise pass instead of a scatter).
            sim = sim.at[mu, mi].set(NEG_INF, mode="drop")
            if valid_items < num_items:
                # Zero-embedding pad items score 0; hard-mask the tail.
                sim = jnp.where(
                    jnp.arange(num_items) < valid_items, sim, NEG_INF
                )
        # Packed-bitmask masking (one fused unpack+select pass, no
        # scatter, no (T, I) copy — the item axis is padded to a 128
        # multiple up front with pad bits set) + selection live in
        # masked_topk, shared with the sharded and serving paths.
        return carry, masked_topk(sim, bits, k)

    _, (scores, ids) = jax.lax.scan(
        body, None, (user_tiles, mask_u, mask_i, mask_bits)
    )
    return scores, ids


_topk_all_tiles = functools.partial(
    jax.jit, static_argnames=("k", "valid_items")
)(topk_all_tiles_impl)


def _pairs_by_tile(
    train_pairs: np.ndarray, num_users: int, tile: int
) -> list[np.ndarray]:
    """Group (user, item) pairs by user tile, users made tile-local."""
    num_tiles = -(-num_users // tile)
    buckets: list[list[np.ndarray]] = [[] for _ in range(num_tiles)]
    if len(train_pairs):
        t = train_pairs[:, 0] // tile
        order = np.argsort(t, kind="stable")
        sorted_pairs = train_pairs[order]
        tile_ids = t[order]
        bounds = np.searchsorted(tile_ids, np.arange(num_tiles + 1))
        for ti in range(num_tiles):
            buckets[ti].append(sorted_pairs[bounds[ti] : bounds[ti + 1]])
    return [
        np.concatenate(b, axis=0) if b else np.zeros((0, 2), np.int32)
        for b in buckets
    ]


# Packed train-mask bitmaps are used when they fit this budget; above it
# the evaluator falls back to per-pair scatter masking.
MASK_BITS_MAX_BYTES = 1 << 30


def pad_bits_words(lo: int, hi: int, words: int) -> np.ndarray:
    """(words,) u32 word row with bits [lo, hi) set — the shared
    pad-region mask (item ids at/above the real item count are
    hard-masked everywhere a packed bitmap is built: the evaluator's
    constructor and rebuild paths, pack_train_bits, and serving's
    no-bitmap request path)."""
    row = np.zeros((words,), np.uint32)
    if hi > lo:
        ids = np.arange(lo, hi)
        np.bitwise_or.at(
            row, ids >> 5, np.uint32(1) << (ids & 31).astype(np.uint32)
        )
    return row


def pack_train_bits(
    train_pairs: np.ndarray | None,
    num_rows: int,
    num_items: int,
    pad_items: int | None = None,
) -> np.ndarray:
    """Pack (user, item) pairs into a (num_rows, ceil(pad_items/32)) u32
    bitmap; bits for item ids in [num_items, pad_items) are pre-set so the
    pad region is hard-masked. Row ids index rows directly (callers pass
    tile-local or shard-local user ids)."""
    if pad_items is None:
        pad_items = num_items
    words = -(-pad_items // 32)
    bits = np.zeros((num_rows, words), np.uint32)
    if train_pairs is not None and len(train_pairs):
        np.bitwise_or.at(
            bits,
            (train_pairs[:, 0], train_pairs[:, 1] >> 5),
            np.uint32(1) << (train_pairs[:, 1] & 31).astype(np.uint32),
        )
    if pad_items > num_items:
        bits |= pad_bits_words(num_items, pad_items, words)[None, :]
    return bits


class TiledEvaluator:
    """Reusable tiled evaluator: the train-pair mask tensors are built and
    uploaded once (they are static per dataset), so repeated evaluations
    only move (U, k) results.

    The train mask itself is stored as a packed (U, ceil(I/32)) bitmap when
    it fits MASK_BITS_MAX_BYTES: applying it is one fused elementwise pass
    per tile, versus a per-pair scatter."""

    def __init__(
        self,
        train_pairs: np.ndarray | None,
        num_users: int,
        user_tile: int = 512,
        *,
        num_items: int | None = None,
    ):
        self.num_users = num_users
        self.user_tile = user_tile
        self.num_tiles = -(-num_users // user_tile)
        if train_pairs is None:
            train_pairs = np.zeros((0, 2), np.int32)
        train_pairs = np.asarray(train_pairs)
        if num_items is None:
            num_items = (
                int(train_pairs[:, 1].max()) + 1 if len(train_pairs) else 1
            )
        self._mask_items = num_items
        # The item axis is padded once to a multiple of 128 so that no
        # stage ever pads the (T, I) f32 score matrix itself (a concatenate
        # pad copies the whole tile). Pad ITEMS in the bitmask (pad bits hard-masked to 1)
        # and pad item_emb rows with zeros instead — then every reshape is
        # a contiguous bitcast and the mask is one fused elementwise pass.
        pad_items = -(-num_items // 128) * 128
        self._pad_items = pad_items
        words = pad_items // 32
        bits_bytes = self.num_tiles * user_tile * words * 4
        if bits_bytes <= MASK_BITS_MAX_BYTES:
            bits = np.zeros(
                (self.num_tiles * user_tile, words), np.uint32
            )
            if len(train_pairs):
                np.bitwise_or.at(
                    bits,
                    (train_pairs[:, 0], train_pairs[:, 1] >> 5),
                    np.uint32(1) << (train_pairs[:, 1] & 31).astype(np.uint32),
                )
            if pad_items > num_items:
                bits |= pad_bits_words(num_items, pad_items, words)[None, :]
            self.mask_bits = jnp.asarray(
                bits.reshape(self.num_tiles, user_tile, words)
            )
            self.mask_u = jnp.zeros((self.num_tiles, 1), jnp.int32)
            self.mask_i = jnp.zeros((self.num_tiles, 1), jnp.int32)
            return
        self.mask_bits = None
        buckets = _pairs_by_tile(train_pairs, num_users, user_tile)
        pmax = max(1, max(len(b) for b in buckets))
        mask_u = np.full((self.num_tiles, pmax), user_tile, np.int32)
        mask_i = np.zeros((self.num_tiles, pmax), np.int32)
        for ti, pairs in enumerate(buckets):
            if len(pairs):
                mask_u[ti, : len(pairs)] = pairs[:, 0] % user_tile
                mask_i[ti, : len(pairs)] = pairs[:, 1]
        self.mask_u = jnp.asarray(mask_u)
        self.mask_i = jnp.asarray(mask_i)

    def topk(
        self,
        user_emb,
        item_emb,
        k: int,
        *,
        return_scores: bool = False,
        device: bool = False,
    ):
        """Ranked exact top-k ids per user (train items masked).

        device=True keeps the ids on device (a (U, k) jnp array) for
        on-device metric evaluation, so only the metrics reach the host.
        """
        user_emb = jnp.asarray(user_emb)
        item_emb = jnp.asarray(item_emb)
        num_items = int(item_emb.shape[0])
        pad_items = -(-num_items // 128) * 128
        if self.mask_bits is not None:
            w_needed = pad_items // 32
            if (
                self.mask_bits.shape[2] != w_needed
                or self._mask_items != num_items
            ):
                # Item space wider than the pairs implied: rebuild the pad
                # region — old pad bits (hard-masked 1s) may now cover real
                # items, and the new tail needs masking. Host-side, cached.
                bits = np.array(self.mask_bits).reshape(
                    self.num_tiles * self.user_tile, -1
                )
                old_valid = self._mask_items
                old_pad = np.arange(old_valid, bits.shape[1] * 32)
                clear = np.zeros((bits.shape[1],), np.uint32)
                np.bitwise_or.at(
                    clear,
                    old_pad >> 5,
                    np.uint32(1) << (old_pad & 31).astype(np.uint32),
                )
                bits &= ~clear[None, :]
                if w_needed > bits.shape[1]:
                    bits = np.concatenate(
                        [
                            bits,
                            np.zeros(
                                (bits.shape[0], w_needed - bits.shape[1]),
                                np.uint32,
                            ),
                        ],
                        axis=1,
                    )
                if pad_items > num_items:
                    bits |= pad_bits_words(
                        num_items, pad_items, w_needed
                    )[None, :]
                self._mask_items = num_items
                self.mask_bits = jnp.asarray(
                    bits.reshape(self.num_tiles, self.user_tile, w_needed)
                )
        if pad_items > num_items:
            item_emb = jnp.concatenate(
                [
                    item_emb,
                    jnp.zeros(
                        (pad_items - num_items, item_emb.shape[1]),
                        item_emb.dtype,
                    ),
                ]
            )
        pad_rows = self.num_tiles * self.user_tile - self.num_users
        if pad_rows:
            user_emb = jnp.concatenate(
                [
                    user_emb,
                    jnp.zeros((pad_rows, user_emb.shape[1]), user_emb.dtype),
                ]
            )
        user_tiles = user_emb.reshape(self.num_tiles, self.user_tile, -1)
        scores, ids = _topk_all_tiles(
            user_tiles,
            item_emb,
            self.mask_u,
            self.mask_i,
            self.mask_bits,
            k=k,
            valid_items=num_items,
        )
        ids = ids.reshape(self.num_tiles * self.user_tile, k)[
            : self.num_users
        ]
        if not device:
            ids = np.asarray(ids).astype(np.int32)
        if not return_scores:
            return None, ids
        scores = scores.reshape(-1, k)[: self.num_users]
        if not device:
            scores = np.asarray(scores)
        return scores, ids


def topk_scores(
    user_emb,
    item_emb,
    k: int,
    *,
    train_pairs: np.ndarray | None = None,
    user_tile: int = 512,
) -> tuple[np.ndarray, np.ndarray]:
    """One-shot wrapper over TiledEvaluator (see class docstring).

    Returns (scores (U, k) f32, ids (U, k) i32) as numpy arrays.
    """
    ev = TiledEvaluator(
        train_pairs, int(user_emb.shape[0]), user_tile=user_tile
    )
    return ev.topk(user_emb, item_emb, k, return_scores=True)


def sharded_pad_items(mesh, num_items: int) -> int:
    """Item-axis width the distributed top-k runs at: ``num_items`` padded
    up to a multiple of ``128 * n_model`` so (a) every model shard's slice
    is a multiple of 128 items and its bitmask slice is word-aligned, and (b)
    shard_map's strict divisibility holds for ANY dataset geometry
    (AmazonBooks' 91,599 items included). Pad rows are
    zero embeddings AND pre-set bits in the packed train mask
    (:func:`pack_train_bits` ``pad_items``), so they rank at NEG_INF and
    can never surface in the merged top-k."""
    from heat_cf.parallel.mesh import MODEL_AXIS

    gran = 128 * mesh.shape[MODEL_AXIS]
    return -(-num_items // gran) * gran


def sharded_topk_supported(
    mesh, num_items: int, k: int, num_users: int
) -> bool:
    """Geometry check for :func:`sharded_topk` at the PADDED item width
    (:func:`sharded_pad_items` — any ``num_items`` is shardable after
    padding). False only when the user axis cannot split evenly over the
    data axis or when ``k`` exceeds the items per model shard (the
    per-shard candidate set must cover a full global top-k) or the number
    of real items."""
    from heat_cf.parallel.mesh import DATA_AXIS, MODEL_AXIS

    n_model = mesh.shape[MODEL_AXIS]
    n_data = mesh.shape[DATA_AXIS]
    i_loc = sharded_pad_items(mesh, num_items) // n_model
    return num_users % n_data == 0 and k <= i_loc and k <= num_items


@functools.lru_cache(maxsize=32)
def make_sharded_topk(
    mesh,
    k: int,
    user_chunk: int = 1024,
):
    """Build (and cache) the jitted distributed top-k program for a mesh.

    See :func:`sharded_topk` for semantics; cached so repeated evaluations
    reuse one compiled program per (mesh, k).
    """
    return _build_sharded_topk(mesh, k, user_chunk)


def sharded_topk(
    mesh,
    user_emb,
    item_emb,
    bits,
    k: int,
    *,
    user_chunk: int = 1024,
):
    """Distributed exact top-k over a GSPMD mesh — the replacement for
    "allgather the item table to every host" (reference analog: every
    rank scores its users against the GLOBAL item table,
    engine.cpp:388-400).

    shard_map kernel per (data, model) shard:
      1. score this shard's user rows against its LOCAL item rows
         (U_loc x I_loc GEMM, user-chunked to bound memory),
      2. apply this shard's slice of the packed train-pair bitmask,
      3. per-shard exact top-k with ids rebased to GLOBAL item ids,
      4. all_gather the k candidates per model shard (k * n_model per user
         — the ONLY cross-shard item traffic) and merge exactly.

    No device ever materializes more than (user_chunk, I_loc) scores plus
    its own table shards; exactness follows from per-shard exactness plus
    the exact merge.

    Geometry: callers pad the item axis to :func:`sharded_pad_items`
    (zero embedding rows + pad bits set via ``pack_train_bits``'s
    ``pad_items``) so ANY dataset geometry shards evenly; the residual
    requirements (num_users divisible by n_data, k <= padded items per
    shard) are checked by :func:`sharded_topk_supported`.

    Args:
      user_emb: (U, d) sharded P("data", None).
      item_emb: (I_pad, d) sharded P("model", None), item axis padded to
        ``sharded_pad_items`` with zero rows.
      bits: (U, I_pad//32) u32 packed train mask, sharded P("data", None)
        (:func:`pack_train_bits` rows per user, global item ids, pad bits
        pre-set).
      k: ranks to return.

    Returns:
      (scores, ids): (U, k) arrays sharded P("data", None), descending.
    """
    return make_sharded_topk(mesh, k, user_chunk)(
        user_emb, item_emb, bits
    )


def _build_sharded_topk(mesh, k, user_chunk):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from heat_cf.parallel.mesh import DATA_AXIS, MODEL_AXIS

    def kernel(u_loc, i_loc_rows, bits_loc):
        i_loc = i_loc_rows.shape[0]  # items per model shard
        w_loc = i_loc // 32
        m_idx = jax.lax.axis_index(MODEL_AXIS)
        item_offset = m_idx * i_loc
        item_t = i_loc_rows.astype(jnp.float32).T
        my_bits = jax.lax.dynamic_slice_in_dim(
            bits_loc, m_idx * w_loc, w_loc, axis=1
        )
        u_rows = u_loc.shape[0]
        chunk = min(user_chunk, u_rows)
        n_chunks = -(-u_rows // chunk)
        pad = n_chunks * chunk - u_rows
        if pad:
            u_loc = jnp.concatenate(
                [u_loc, jnp.zeros((pad, u_loc.shape[1]), u_loc.dtype)]
            )
            my_bits = jnp.concatenate(
                [my_bits, jnp.zeros((pad, w_loc), my_bits.dtype)]
            )
        u_chunks = u_loc.reshape(n_chunks, chunk, -1)
        b_chunks = my_bits.reshape(n_chunks, chunk, w_loc)

        def body(carry, xs):
            uc, bc = xs
            # precision=HIGHEST: ranking feeds on these scores (see
            # topk_all_tiles_impl for the TF32 hazard).
            sim = jnp.dot(
                uc.astype(jnp.float32),
                item_t,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            s, ids = masked_topk(sim, bc, k)
            return carry, (s, ids.astype(jnp.int32) + item_offset)

        _, (s, ids) = jax.lax.scan(body, None, (u_chunks, b_chunks))
        s = s.reshape(n_chunks * chunk, k)[:u_rows]
        ids = ids.reshape(n_chunks * chunk, k)[:u_rows]
        # Merge across model shards: k * n_model candidates per user.
        s_all = jax.lax.all_gather(s, MODEL_AXIS, axis=1, tiled=True)
        ids_all = jax.lax.all_gather(ids, MODEL_AXIS, axis=1, tiled=True)
        s_top, sel = jax.lax.top_k(s_all, k)
        return s_top, jnp.take_along_axis(ids_all, sel, axis=1)

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None),
            P(MODEL_AXIS, None),
            P(DATA_AXIS, None),
        ),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
        check_rep=False,
    )
    return jax.jit(fn)


def full_sim_matrix(user_emb, item_emb) -> np.ndarray:
    """The reference ``evaluate0`` API (engine.cpp:388-400): the dense
    user x item dot-product matrix. Only for small problems / parity tests —
    production evaluation uses :func:`topk_scores`."""
    sim = jnp.dot(
        jnp.asarray(user_emb, jnp.float32),
        jnp.asarray(item_emb, jnp.float32).T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,  # reference f32 GEMM fidelity
    )
    return np.asarray(sim)
