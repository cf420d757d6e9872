"""Training engine: epoch orchestration over the jitted scan.

Accelerator-resident counterpart of the reference ``train::Engine``
(engine.cpp:67-386). One epoch is one (or ``num_subepochs``) device
program(s): the host only schedules the learning rate (engine.cpp:156-160),
builds the epoch permutation, and launches the jitted scan — there is no
per-sample Python/C++ boundary crossing and no per-row collective traffic.

Sub-epoch item partitioning (the reference's model-parallel scheme,
engine.cpp:91-131): when num_subepochs > 1, a per-epoch random permutation
of item columns defines ``num_subepochs`` partitions; training pairs are
bucketed by their positive item's partition, each sub-epoch trains one
bucket with negatives constrained to the partition's complement
(engine.cpp:222-237), and gradient accumulators are zeroed at sub-epoch
boundaries (engine.cpp:344-347). On a device mesh this bounds the staleness
window of the item shards; on one device it is a faithful capability parity
mode (there is nothing to synchronize).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from heat_cf.config import CFConfig, SGD_MODE_ACCUM
from heat_cf.data.datasets import ClickDataset, user_range_bounds
from heat_cf.evaluation.evaluator import TiledEvaluator, full_sim_matrix
from heat_cf.evaluation.metrics import (
    evaluate_metrics,
    evaluate_metrics_device,
    pad_truth,
    parse_metric,
)
from heat_cf.models.state import (
    TrainState,
    init_train_state,
    zero_grad_accumulators,
)
from heat_cf.models.aggregator import aggregate_history, user_pools_impl
from heat_cf.train.optimizer import scheduled_lr
from heat_cf.train.samplers import derive_tile_params, init_sampler_state
from heat_cf.train.train_step import (
    make_epoch_fn,
    make_multi_epoch_fn,
    shuffle_pairs,
)
from heat_cf.utils.profiling import PhaseTimer, performance_breakdown


def _process_local_rows(arr) -> np.ndarray:
    """This process's rows of a dim-0-sharded global array (deduplicating
    replicas along other mesh axes)."""
    by_start: dict[int, np.ndarray] = {}
    for s in arr.addressable_shards:
        start = s.index[0].start or 0
        if start not in by_start:
            by_start[start] = np.asarray(s.data)
    return np.concatenate(
        [by_start[k] for k in sorted(by_start)], axis=0
    )


# Chunked whole-table pooling (backs cfg.his_refresh == "subepoch"); the
# implementation lives next to the pooling math in models/aggregator.py.
compute_user_pools = functools.partial(
    jax.jit,
    static_argnames=("chunk", "aggregator", "max_his", "logical_dim"),
)(user_pools_impl)


@functools.partial(jax.jit, static_argnames=("num_batches", "batch"))
def _permute_batches(
    key: jax.Array, pairs: jnp.ndarray, num_batches: int, batch: int
):
    """Shuffle pairs and pack into (num_batches, batch) with weight padding.

    The epoch-order shuffle is the reference's ``random::Shuffle`` positive
    sampler (shuffle.hpp:13-48, engine.cpp:15). Implemented as ONE
    sort-with-payload (random 32-bit keys carrying both id columns) — the
    same shuffle ``jax.random.permutation`` computes internally, but without
    re-gathering the pairs through the permutation afterwards (one pass
    over the pairs fewer; the GPU timing of both forms is not measured).
    """
    n = pairs.shape[0]
    total = num_batches * batch
    # Padding rows repeat real rows but carry weight 0 (their losses,
    # gradients, and write-backs are redirected/zeroed in train_step).
    # shuffle_pairs tiles to cover the multi-host case where the
    # batch-count agreement can make total exceed 2n (short shards pad
    # a lot).
    su, sp = shuffle_pairs(key, pairs, total)
    weight = (jnp.arange(total) < n).astype(jnp.float32).reshape(
        num_batches, batch
    )
    return su.reshape(num_batches, batch), sp.reshape(num_batches, batch), weight


@functools.partial(jax.jit, static_argnames=("num_batches", "batch"))
def _permute_batches_padded(
    key: jax.Array,
    pairs_padded: jnp.ndarray,
    n: jnp.ndarray,
    num_batches: int,
    batch: int,
):
    """Shape-static variant of ``_permute_batches`` for sub-epoch buckets.

    Bucket sizes vary EVERY epoch (the item partition is redrawn), and a
    jit keyed on the concrete (n, 2) input shape would recompile every
    epoch, a compile far longer than the epoch's compute. Here the
    bucket is host-padded to a cached static row cap (num_batches * batch) and the TRUE row count ``n`` rides as a traced
    scalar: pad rows get sort key 0xFFFFFFFF so the (stable) sort sends
    them to the end — the first ``n`` shuffled rows are bit-identical to
    ``_permute_batches`` on the unpadded bucket (same counter-mode bit
    stream prefix, same stable order) — and ``weight`` masks them out.
    """
    total = num_batches * batch
    keys = jax.random.bits(key, (total,))
    real = jnp.arange(total, dtype=jnp.int32) < n
    # Real keys cap at 0xFFFFFFFE so a real row can never tie a pad under
    # the (unstable) sort and land past position n (a pad would then be
    # weighted real in its place). Affects the shuffle only on 2^-32 key
    # ties, which the unpadded path's unstable sort breaks arbitrarily
    # anyway.
    keys = jnp.where(
        jnp.logical_and(real, keys == jnp.uint32(0xFFFFFFFF)),
        jnp.uint32(0xFFFFFFFE),
        keys,
    )
    keys = jnp.where(real, keys, jnp.uint32(0xFFFFFFFF))
    _, su, sp = jax.lax.sort(
        (keys, pairs_padded[:, 0], pairs_padded[:, 1]),
        dimension=0,
        num_keys=1,
    )
    weight = real.astype(jnp.float32).reshape(num_batches, batch)
    return (
        su.reshape(num_batches, batch),
        sp.reshape(num_batches, batch),
        weight,
    )


@functools.partial(jax.jit, static_argnames=("num_batches", "batch"))
def _pack_batches_padded(
    pairs_padded: jnp.ndarray,
    n: jnp.ndarray,
    num_batches: int,
    batch: int,
):
    """Shape-static ``_pack_batches`` (shuffle_mode "none") for sub-epoch
    buckets: parse order preserved, pad rows (already at the tail) masked
    by the traced true count ``n``."""
    total = num_batches * batch
    weight = (
        (jnp.arange(total, dtype=jnp.int32) < n)
        .astype(jnp.float32)
        .reshape(num_batches, batch)
    )
    return (
        pairs_padded[:, 0].reshape(num_batches, batch),
        pairs_padded[:, 1].reshape(num_batches, batch),
        weight,
    )


@functools.partial(jax.jit, static_argnums=(1, 2))
def _pack_batches(pairs: jnp.ndarray, num_batches: int, batch: int):
    """Pack pairs into (num_batches, batch) in parse order, no shuffle
    (cfg.shuffle_mode == "none" — the fork's live MPI hot loop walks its
    buckets in parse order, engine.cpp:243-252)."""
    n = pairs.shape[0]
    total = num_batches * batch
    su, sp = pairs[:, 0], pairs[:, 1]
    if total > n:
        reps = -(-total // n)
        su = jnp.tile(su, reps)[:total]
        sp = jnp.tile(sp, reps)[:total]
    weight = (jnp.arange(total) < n).astype(jnp.float32).reshape(
        num_batches, batch
    )
    return su.reshape(num_batches, batch), sp.reshape(num_batches, batch), weight


class Engine:
    """Drives training/evaluation for one model on one process.

    Args:
      cfg: hyperparameters (num_users/num_items/train_size are taken from
        ``train_data``, mirroring datasets.py:71-79 updating the config).
      train_data: parsed click data (this process's user shard).
      test_data: held-out clicks for ranking metrics (optional).
    """

    def __init__(
        self,
        cfg: CFConfig,
        train_data: ClickDataset,
        test_data: Optional[ClickDataset] = None,
        seed: Optional[int] = None,
        mesh=None,
    ):
        cfg.num_users = train_data.num_users
        cfg.num_items = train_data.num_items
        cfg.train_size = train_data.train_size
        if mesh is not None and jax.process_count() > 1:
            # Global sample count for the epoch-loss mean (the reference
            # Allreduces iteration counts, engine.cpp:381-383).
            from jax.experimental import multihost_utils

            counts = multihost_utils.process_allgather(
                np.asarray([train_data.train_size])
            )
            cfg.train_size = int(np.sum(counts))
        if cfg.neg_sampler == 1 and cfg.tile_size <= 0:
            # "auto": the paper's Alg. 1 tile tuning, adapted to a device
            # step's working set (samplers.derive_tile_params).
            cfg.tile_size, cfg.refresh_interval = derive_tile_params(cfg)
        self.cfg = cfg
        self.train_data = train_data
        self.test_data = test_data
        self.epoch = 0
        self.mesh = mesh

        seed = cfg.seed if seed is None else seed
        root = jax.random.key(seed)
        k_state, k_sampler, self._key = jax.random.split(root, 3)
        if mesh is None:
            self.state: TrainState = init_train_state(cfg, k_state)
        self.sampler_state = init_sampler_state(cfg, k_sampler)

        if (
            cfg.visit_order != "file"
            and int(np.shape(train_data.pairs)[0]) > 0
        ):
            # Stable pre-sort of the visit stream (config.py docstring;
            # measured at full scale in DESIGN.md 6h/6i): "user" groups
            # clicks by user on any input order (enables the
            # history-gather dedup under fixed streams), "item" groups
            # by item (the measured-best CCL order). Sorted on host
            # BEFORE the one device upload. Multi-host: sorts this
            # process's user-range shard — the global visit semantics
            # match the single-host ones per shard.
            col = 0 if cfg.visit_order == "user" else 1
            pnp = np.asarray(train_data.pairs)
            order = np.argsort(pnp[:, col], kind="stable")
            self.pairs = jnp.asarray(pnp[order], jnp.int32)
        else:
            self.pairs = jnp.asarray(train_data.pairs, jnp.int32)
        # Short histories are stored flat (U*H,): the layout was chosen on
        # the previous accelerator, whose tiling padded a (U, H) int32
        # array's minor dim to 128 (12.8x at rest for H=10); it is kept
        # until re-derived on the GPU. train_step/compute_user_pools
        # dispatch on ndim (gather arithmetic identical).
        his_np = np.asarray(train_data.his_items, np.int32)
        # (train_step's flat gather strides by cfg.max_his, so only flatten
        # when the dataset's history width actually matches it.)
        self._flat_his = cfg.max_his < 64 and his_np.shape[1] == cfg.max_his
        if self._flat_his:
            his_np = his_np.reshape(-1)
        self.his_items = jnp.asarray(his_np)
        self.his_masks = jnp.asarray(train_data.masks, jnp.int32)

        self._multiprocess = mesh is not None and jax.process_count() > 1
        self._pad_users = 0
        self._pad_items = 0
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from heat_cf.parallel.mesh import (
                DATA_AXIS,
                MODEL_AXIS,
                batch_sharding,
                train_state_shardings,
            )

            self._batch_sharding = batch_sharding(mesh)
            self._data_axis_size = mesh.shape[DATA_AXIS]
            # Row-shard divisibility: GSPMD requires table dim 0 divisible
            # by its mesh axis. Single-process meshes pad the tables (and
            # the history arrays) with dead rows — never sampled (samplers
            # draw from the LOGICAL cfg.num_items), never batched (batch
            # ids are logical), zero-masked in pooling, and sliced off by
            # evaluate()/unpadded_state(). Multi-host keeps the strict
            # divisibility requirement (host data shards must align).
            state_cfg = cfg
            if not self._multiprocess:
                self._pad_users = (-cfg.num_users) % self._data_axis_size
                self._pad_items = (-cfg.num_items) % mesh.shape[MODEL_AXIS]
                if self._pad_users or self._pad_items:
                    state_cfg = dataclasses.replace(
                        cfg,
                        num_users=cfg.num_users + self._pad_users,
                        num_items=cfg.num_items + self._pad_items,
                    )
                if self._pad_users:
                    if self._flat_his:
                        his_pad = np.zeros(
                            (self._pad_users * cfg.max_his,), np.int32
                        )
                    else:
                        his_pad = np.zeros(
                            (self._pad_users, self.his_items.shape[1]),
                            np.int32,
                        )
                    self.his_items = jnp.concatenate(
                        [self.his_items, jnp.asarray(his_pad)]
                    )
                    self.his_masks = jnp.concatenate(
                        [
                            self.his_masks,
                            jnp.zeros((self._pad_users,), jnp.int32),
                        ]
                    )
            # Initialize the state directly into its sharded layout (works
            # both single-process and multi-host: each process materializes
            # only its addressable shards).
            template = jax.eval_shape(
                lambda k: init_train_state(state_cfg, k), k_state
            )
            shardings = train_state_shardings(mesh, template)
            self.state = jax.jit(
                lambda k: init_train_state(state_cfg, k),
                out_shardings=shardings,
            )(k_state)
            row_sh = NamedSharding(mesh, P(DATA_AXIS, None))
            vec_sh = NamedSharding(mesh, P(DATA_AXIS))
            # Sampler state rides along replicated so committed restores
            # (checkpointing) cannot conflict with the mesh layout.
            self._replicated = NamedSharding(mesh, P())
            self.sampler_state = jax.tree.map(
                lambda x: jax.device_put(x, self._replicated),
                self.sampler_state,
            )
            if self._multiprocess:
                # train_data is this process's user-range slice with GLOBAL
                # ids (shard_by_user_range(..., rebase=False)); its history
                # rows are exactly this host's addressable slice of the
                # global (U, H) table.
                if cfg.num_users % self._data_axis_size:
                    raise ValueError(
                        "multi-host runs require num_users divisible by the "
                        f"data axis ({self._data_axis_size})"
                    )
                his_local = np.asarray(train_data.his_items, np.int32)
                if self._flat_his:
                    his_local = his_local.reshape(-1)
                self.his_items = jax.make_array_from_process_local_data(
                    vec_sh if self._flat_his else row_sh, his_local
                )
                self.his_masks = jax.make_array_from_process_local_data(
                    vec_sh, np.asarray(train_data.masks)
                )
            else:
                self.his_items = jax.device_put(
                    self.his_items, vec_sh if self._flat_his else row_sh
                )
                self.his_masks = jax.device_put(self.his_masks, vec_sh)
        else:
            self._batch_sharding = None
            self._data_axis_size = 1
            self._replicated = None

        self._epoch_fn = make_epoch_fn(cfg)
        self._multi_epoch_fn = None  # built lazily by train_epochs
        # One-dispatch sub-epoch epochs (uniform sampler + SGD); tests
        # flip this off to compare against the per-bucket dispatch path.
        self._fuse_subepochs = True
        self._np_rng = np.random.default_rng(seed ^ 0x5EED)
        # Host-visible phase accumulation (the reference's time_map /
        # performance_breakdown, engine.cpp:22-65, at engine granularity).
        self.timer = PhaseTimer()
        self._evaluator = None  # lazy TiledEvaluator (mask tensors cached)
        self._batch_cache = None  # shuffle_mode == "once" packed stream

    # ------------------------------------------------------------------
    def unpadded_state(self) -> TrainState:
        """The train state with mesh-divisibility padding rows sliced off.

        Single-process meshes pad table rows so GSPMD can row-shard any
        num_users/num_items (see __init__); use this for serving, export,
        or any consumer that treats table row ids as entity ids.
        """
        if not (self._pad_users or self._pad_items):
            return self.state
        nu, ni = self.cfg.num_users, self.cfg.num_items

        def cut(x, n):
            return None if x is None else x[:n]

        return self.state.replace(
            user_emb=self.state.user_emb[:nu],
            item_emb=self.state.item_emb[:ni],
            user_gacc=cut(self.state.user_gacc, nu),
            item_gacc=cut(self.state.item_gacc, ni),
            opt_slots=None
            if self.state.opt_slots is None
            else {
                k: (v[:nu] if k.startswith("user_") else v[:ni])
                if k.startswith(("user_", "item_"))
                else v
                for k, v in self.state.opt_slots.items()
            },
        )

    # ------------------------------------------------------------------
    def _pooled_history(self) -> jnp.ndarray:
        """(U, d) pooled history under the configured aggregator."""
        cfg = self.cfg
        return compute_user_pools(
            self.state.item_emb,
            self.his_items,
            self.his_masks,
            user_emb=(
                self.state.user_emb
                if cfg.aggregator == "user_attention"
                else None
            ),
            attn_q=self.state.attn_q,
            aggregator=cfg.aggregator,
            max_his=cfg.max_his,
            logical_dim=cfg.emb_dim if cfg.emb_pad else None,
        )

    def _next_key(self) -> jax.Array:
        self._key, sub = jax.random.split(self._key)
        return sub

    def _shuffle_or_pack(self, pairs, num_batches: int, batch: int):
        """Dispatch on cfg.shuffle_mode; "once" caches the packed stream
        per pairs object (a strong ref pins the keying identity).

        Key discipline: "once" draws (and may discard) exactly one key per
        call so every host's key stream stays aligned with the
        empty-shard compensating draw in _make_batches; "none" draws none
        (on every host uniformly).
        """
        mode = self.cfg.shuffle_mode
        if mode == "none":
            return _pack_batches(pairs, num_batches, batch)
        key = self._next_key()
        if mode == "once":
            cached = self._batch_cache
            if (
                cached is not None
                and cached[0] is pairs
                and cached[1] == (num_batches, batch)
            ):
                return cached[2]
            out = _permute_batches(key, pairs, num_batches, batch)
            self._batch_cache = (pairs, (num_batches, batch), out)
            return out
        return _permute_batches(key, pairs, num_batches, batch)

    def _subepoch_geometry(self, ns: list[int]) -> tuple[int, int]:
        """Static (batch, num_batches) for sub-epoch bucket packing —
        cached and GROW-ONLY, so the per-epoch jitter in bucket sizes
        never changes a compiled shape. The cap carries one extra batch
        plus ~6% slack over the first epoch's need; it regrows (one
        recompile) only if a later partition overflows it."""
        cfg = self.cfg
        batch = min(cfg.batch_size, max(1, max(ns)))
        batch = -(-batch // self._data_axis_size) * self._data_axis_size
        need_nb = max([-(-n // batch) for n in ns if n > 0] or [1])
        cached = getattr(self, "_subep_geom", None)
        if cached is not None and cached[0] == batch and cached[1] >= need_nb:
            return cached
        self._subep_geom = (batch, need_nb + 1 + need_nb // 16)
        return self._subep_geom

    def _subepoch_multi_prep(self, epochs: int):
        """Host prep for an E-epoch fused sub-epoch program, mirroring
        train_one_epoch's per-epoch work: item permutation (host rng —
        per-bucket-oracle parity), bucket counts, grow-only geometry.
        The packed batch width must be epoch-invariant for one program
        (production buckets >> batch_size always are); if bucket jitter
        would change it, the rng is REWOUND and None returned so the
        caller falls back to per-epoch dispatch with identical draws.

        Returns (s_count, batch, nb, perms, counts_list) or None."""
        cfg = self.cfg
        rng_snapshot = self._np_rng.bit_generator.state
        geom_snapshot = getattr(self, "_subep_geom", None)
        s_count = cfg.num_subepochs
        pairs_np = np.asarray(self.pairs)
        bounds = np.linspace(
            0, cfg.num_items, s_count + 1
        ).astype(np.int64)
        perms, counts_list, geoms = [], [], []
        for _ in range(epochs):
            perm = self._np_rng.permutation(cfg.num_items)
            part_of = np.empty(cfg.num_items, np.int64)
            for s in range(s_count):
                part_of[perm[bounds[s] : bounds[s + 1]]] = s
            counts = np.bincount(
                part_of[pairs_np[:, 1]], minlength=s_count
            )
            perms.append(perm.astype(np.int32))
            counts_list.append(counts)
            geoms.append(
                self._subepoch_geometry([int(c) for c in counts])
            )
        # Bail (rewind rng AND the grow-only geometry cache that the
        # loop above may have mutated) unless both batch width AND nb
        # are epoch-invariant: nb feeds jax.random.split(k_epoch, nb)
        # and jax.random.bits(k, (nb*batch,)) inside the device program,
        # so a mid-run regrow would silently void the tested bit-exact
        # equivalence with sequential train_one_epoch calls.
        if len({g for g in geoms}) != 1:
            self._np_rng.bit_generator.state = rng_snapshot
            if geom_snapshot is None:
                if hasattr(self, "_subep_geom"):
                    del self._subep_geom
            else:
                self._subep_geom = geom_snapshot
            return None
        return (
            s_count,
            geoms[0][0],
            geoms[0][1],
            perms,
            counts_list,
        )

    def _subepoch_draw_keys(self, counts_list):
        """Stacked (E, S) shuffle/epoch keys with the same draw
        discipline as ``_run_subepochs_fused_device``, epoch by epoch:
        per NON-EMPTY bucket one shuffle key (shuffling modes only) +
        one epoch key; empty buckets consume no draws."""
        cfg = self.cfg
        sks, eks = [], []
        for counts in counts_list:
            row_s, row_e = [], []
            for n in (int(c) for c in counts):
                if n == 0:
                    row_s.append(jax.random.key(0))
                    row_e.append(jax.random.key(0))
                    continue
                row_s.append(
                    self._next_key()
                    if cfg.shuffle_mode != "none"
                    else jax.random.key(0)
                )
                row_e.append(self._next_key())
            sks.append(jnp.stack(row_s))
            eks.append(jnp.stack(row_e))
        return jnp.stack(sks), jnp.stack(eks)

    def _shuffle_or_pack_padded(self, pairs_padded, n: int, num_batches: int,
                                batch: int):
        """``_shuffle_or_pack`` over a host-padded bucket (shape-static;
        see ``_permute_batches_padded``). Same key-draw discipline: one
        key for any shuffling mode, none for "none". ("once" draws its
        key but skips the stream cache — sub-epoch buckets are redrawn
        every epoch, so a cache could never hit.)"""
        if self.cfg.shuffle_mode == "none":
            return _pack_batches_padded(
                pairs_padded, jnp.asarray(n, jnp.int32), num_batches, batch
            )
        key = self._next_key()
        return _permute_batches_padded(
            key, pairs_padded, jnp.asarray(n, jnp.int32), num_batches, batch
        )

    def _make_batches(self, pairs: jnp.ndarray):
        """Shuffle + pack local pairs; assemble the (global) batch arrays."""
        cfg = self.cfg
        n = int(pairs.shape[0])
        d_ax = self._data_axis_size
        if not self._multiprocess:
            batch = min(cfg.batch_size, max(1, n))
            batch = -(-batch // d_ax) * d_ax  # divisible by the data axis
            num_batches = -(-n // batch)
            users, pos, weight = self._shuffle_or_pack(
                pairs, num_batches, batch
            )
            if self._batch_sharding is not None:
                users = jax.device_put(users, self._batch_sharding)
                pos = jax.device_put(pos, self._batch_sharding)
                weight = jax.device_put(weight, self._batch_sharding)
            return users, pos, weight
        users, pos, weight = self._local_batches(pairs)
        out = []
        for arr in (users, pos, weight):
            out.append(
                jax.make_array_from_process_local_data(
                    self._batch_sharding, np.asarray(arr)
                )
            )
        return tuple(out)

    def _local_batches(self, pairs: jnp.ndarray):
        """Multi-host: this process's shuffled+packed batch contribution.

        Each process shuffles its local pairs and contributes
        batch_size/P rows per step; processes must agree on the number of
        batches (the reference's ranks implicitly agree by partition
        construction; here the max over hosts is used, short hosts pad).
        Draws exactly the keys ``_shuffle_or_pack`` would (empty shards
        draw and discard one, keeping host key streams aligned).
        """
        from jax.experimental import multihost_utils

        cfg = self.cfg
        n = int(pairs.shape[0])
        d_ax = self._data_axis_size
        nproc = jax.process_count()
        local_batch = max(1, (-(-cfg.batch_size // d_ax) * d_ax) // nproc)
        local_nb = -(-max(1, n) // local_batch)
        all_nb = multihost_utils.process_allgather(np.asarray([local_nb]))
        num_batches = int(np.max(all_nb))
        if n > 0:
            out = self._shuffle_or_pack(pairs, num_batches, local_batch)
        else:
            # Empty shard: all-padding contribution.
            if cfg.shuffle_mode != "none":  # match the draw count above
                self._next_key()
            out = (
                jnp.zeros((num_batches, local_batch), jnp.int32),
                jnp.zeros((num_batches, local_batch), jnp.int32),
                jnp.zeros((num_batches, local_batch), jnp.float32),
            )
        # Stashed for _history_dedup_mp (the global assembly loses the
        # per-host view the dedup maps are computed from).
        self._last_local_users = out[0]
        return out

    def _history_dedup(self, pairs, users) -> Optional[tuple]:
        """Host-precomputed per-batch (uniq_users, inverse, first) maps
        for the train step's history-gather dedup (see train_step
        docstring).

        Applies when the pooled history is recomputed per step from the
        live table (his_refresh == "step" — any aggregator since round 5:
        the attention variants pool per distinct user inside the loss,
        with user_attention's query sliced from the first occurrence of
        the same differentiable u_rows gather) and the batch stream is
        FIXED across epochs (shuffle "none"/"once" — "none" is the fork's
        live MPI visit order, whose user-grouped parse order is exactly
        where duplication is massive). Returns None when users are mostly
        unique (shuffled streams) — the dedup would only add a (B,)
        gather.
        """
        cfg = self.cfg
        if (
            cfg.his_refresh != "step"
            or self._multiprocess  # multi-host: _history_dedup_mp
            or cfg.shuffle_mode not in ("none", "once")
            # user_attention + direct: the dedup concentrates the
            # attention-query gradient into the first occurrence's row,
            # and direct mode clips PER OCCURRENCE before scatter-add —
            # where the clip binds, the concentrated row clips
            # differently than the spread per-occurrence grads, breaking
            # the exact-rewrite contract (dedup-combine updates sum
            # before clipping, so they are unaffected; self_attention's
            # query is a parameter, not a scattered row).
            or (
                cfg.aggregator == "user_attention"
                and cfg.update_mode == "direct"
            )
        ):
            return None
        cache = getattr(self, "_dedup_cache", None)
        key = (id(pairs), users.shape)
        if cache is not None and cache[0] == key:
            return cache[1]
        users_np = np.asarray(users)
        nb, batch = users_np.shape
        uniqs, firsts, invs, max_u = [], [], [], 1
        for b in range(nb):
            uu, first, inv = np.unique(
                users_np[b], return_index=True, return_inverse=True
            )
            uniqs.append(uu)
            firsts.append(first)
            invs.append(inv)
            max_u = max(max_u, len(uu))
        out = None
        if max_u <= 0.7 * batch:  # worth the extra (B,) means gather
            bu = -(-max_u // 8) * 8
            uu_arr = np.zeros((nb, bu), np.int32)
            uf_arr = np.zeros((nb, bu), np.int32)
            for b, (uu, uf) in enumerate(zip(uniqs, firsts)):
                n = len(uu)
                uu_arr[b, :n] = uu
                uu_arr[b, n:] = uu[0] if n else 0
                uf_arr[b, :n] = uf
                uf_arr[b, n:] = uf[0] if n else 0
            out = (
                jnp.asarray(uu_arr),
                jnp.asarray(np.stack(invs).astype(np.int32)),
                jnp.asarray(uf_arr),
            )
        self._dedup_cache = (key, out)
        return out

    def _history_dedup_mp(self, users_local) -> Optional[tuple]:
        """Multi-host history-gather dedup: per-host (uniq, inverse) maps
        over each host's local batch slice, assembled into global
        (nb, Bu) / (nb, B) arrays sharded like the batches.

        Users are partitioned by host range (a user's clicks live on ONE
        host), so per-host dedup is globally exact: no user can occupy
        slots on two hosts. Local slot ids are offset by
        ``process_index * Bu_pad`` (hosts agree on the padded slot width
        by allgather-max), so each inverse entry indexes the GLOBAL slot
        axis; first-occurrence positions (round 5, the attention-dedup
        query source) are offset by ``process_index * batch`` into the
        GLOBAL batch axis under the same contiguous-process-block layout
        the slot offsets already rely on. Gating matches the single-host
        path (fixed streams, per-step history — any aggregator);
        returns None when duplication is too low to pay for the extra
        (B,) means gather on any host.
        """
        cfg = self.cfg
        if (
            cfg.his_refresh != "step"
            or cfg.shuffle_mode not in ("none", "once")
            # Same exactness gate as _history_dedup: per-occurrence
            # clipping vs the concentrated first-occurrence query grad.
            or (
                cfg.aggregator == "user_attention"
                and cfg.update_mode == "direct"
            )
        ):
            return None
        from jax.experimental import multihost_utils

        users_np = np.asarray(users_local)
        nb, batch = users_np.shape
        uniqs, firsts, invs, max_u = [], [], [], 1
        for b in range(nb):
            uu, first, inv = np.unique(
                users_np[b], return_index=True, return_inverse=True
            )
            firsts.append(first)
            uniqs.append(uu)
            invs.append(inv)
            max_u = max(max_u, len(uu))
        # Hosts must agree on BOTH the go/no-go decision and the padded
        # slot width: exchange (max_u, batch) and decide globally.
        stats = multihost_utils.process_allgather(
            np.asarray([max_u, batch])
        ).reshape(jax.process_count(), 2)
        if stats[:, 0].max() > 0.7 * stats[:, 1].min():
            return None
        # Slot width: multiple of 8 AND of the per-host device count so
        # the local (nb, bu) shard subdivides evenly over this host's
        # data-axis positions.
        per_host_dev = max(1, self._data_axis_size // jax.process_count())
        m = max(8, per_host_dev)
        bu = int(-(-stats[:, 0].max() // m) * m)
        uu_arr = np.zeros((nb, bu), np.int32)
        uf_arr = np.zeros((nb, bu), np.int32)
        for b, (uu, uf) in enumerate(zip(uniqs, firsts)):
            n = len(uu)
            uu_arr[b, :n] = uu
            uu_arr[b, n:] = uu[0] if n else 0
            uf_arr[b, :n] = uf
            uf_arr[b, n:] = uf[0] if n else 0
        offset = jax.process_index() * bu
        inv_arr = np.stack(invs).astype(np.int32) + offset
        # First-occurrence positions index the GLOBAL batch axis: local
        # slices occupy contiguous per-process column blocks (the same
        # layout assumption the slot offsets above rely on).
        uf_arr = uf_arr + np.int32(jax.process_index() * batch)
        uniq_g = jax.make_array_from_process_local_data(
            self._batch_sharding, uu_arr
        )
        inv_g = jax.make_array_from_process_local_data(
            self._batch_sharding, inv_arr
        )
        first_g = jax.make_array_from_process_local_data(
            self._batch_sharding, uf_arr
        )
        return uniq_g, inv_g, first_g

    def _dedup_mp_cached(self, pairs) -> Optional[tuple]:
        """Cache wrapper over _history_dedup_mp keyed on the (fixed)
        stream identity — the maps are recomputed only when the packed
        stream changes. Every host runs the same gating collective, so
        cache state stays aligned."""
        key = (id(pairs), tuple(np.shape(self._last_local_users)))
        cache = getattr(self, "_dedup_mp_cache", None)
        if cache is not None and cache[0] == key:
            return cache[1]
        out = self._history_dedup_mp(self._last_local_users)
        self._dedup_mp_cache = (key, out)
        return out

    def _run_pairs(self, pairs: jnp.ndarray, neg_candidates=None) -> float:
        """Scan one pair set (an epoch or a sub-epoch bucket)."""
        cfg = self.cfg
        if int(pairs.shape[0]) == 0 and not self._multiprocess:
            return 0.0
        with self.timer.phase("data"):
            users, pos, weight = self._make_batches(pairs)
            if neg_candidates is not None:
                dedup = None
            elif self._multiprocess:
                dedup = self._dedup_mp_cached(pairs)
            else:
                dedup = self._history_dedup(pairs, users)
        # cfg.his_refresh == "subepoch" pooling ("aggr_f") happens inside
        # the epoch program (make_epoch_fn) so the means table materializes
        # in the scan's own layout — no cross-jit full-table copy.
        with self.timer.phase("f_b"):
            self.state, self.sampler_state, loss_sum = self._epoch_fn(
                self.state,
                self.sampler_state,
                self._next_key(),
                users,
                pos,
                weight,
                self.his_items,
                self.his_masks,
                neg_candidates,
                dedup[0] if dedup else None,
                dedup[1] if dedup else None,
                # uniq_first feeds only the attention dedup; the mean
                # path keeps its round-4 program signature (no unused
                # scanned operand).
                dedup[2]
                if dedup and cfg.aggregator != "mean"
                else None,
            )
            loss_sum = float(loss_sum)
        return loss_sum

    def train_one_epoch(self) -> float:
        """Run one epoch; returns mean per-sample loss (engine.cpp:380-384)."""
        cfg = self.cfg
        lr = scheduled_lr(cfg.l_r, self.epoch, cfg.milestones, cfg.lr_gamma)
        lr_arr = jnp.asarray(lr, jnp.float32)
        if self._replicated is not None:
            lr_arr = jax.device_put(lr_arr, self._replicated)
        self.state = self.state.replace(lr=lr_arr)

        total_loss = 0.0
        if cfg.num_subepochs <= 1:
            total_loss = self._run_pairs(self.pairs)
            if cfg.sgd_mode == SGD_MODE_ACCUM:
                # The reference zeroes the grad tables at the end of EVERY
                # sub-epoch — including the only one (engine.cpp:345-347
                # runs inside the sub-epoch loop).
                self.state = zero_grad_accumulators(self.state)
        else:
            # Item-column partitioning (engine.cpp:91-131).
            perm = self._np_rng.permutation(cfg.num_items)
            part_of = np.empty(cfg.num_items, np.int64)
            bounds = np.linspace(
                0, cfg.num_items, cfg.num_subepochs + 1
            ).astype(np.int64)
            for s in range(cfg.num_subepochs):
                part_of[perm[bounds[s] : bounds[s + 1]]] = s
            pairs_np = np.asarray(self.pairs)
            pair_part = part_of[pairs_np[:, 1]]
            if self._fuse_subepochs and not self._multiprocess:
                # ON-DEVICE bucketing (round 4): the program receives only
                # the permutation + per-bucket counts and sorts/slices/
                # shuffles the device-resident pairs itself — no bucket
                # materialization or upload (the host-packed path
                # uploads every bucket each epoch). Bit-identical to the host
                # path (train_step.make_subepoch_epoch_fn_device).
                counts = np.bincount(
                    pair_part, minlength=cfg.num_subepochs
                )
                self.epoch += 1
                return self._run_subepochs_fused_device(
                    perm, counts
                ) / max(1, cfg.train_size)
            buckets, complements = [], []
            for s in range(cfg.num_subepochs):
                buckets.append(pairs_np[pair_part == s])
                complements.append(
                    perm[
                        np.concatenate(
                            [
                                np.arange(0, bounds[s]),
                                np.arange(bounds[s + 1], cfg.num_items),
                            ]
                        )
                    ].astype(np.int32)
                )
            if self._fuse_subepochs:
                # ONE device program for all S sub-epochs (grad zeroing
                # at sub-epoch boundaries happens inside it). Round 4
                # extended this to the tile sampler and moment
                # optimizers: train_step counts only REAL samples toward
                # the tile-refresh cadence and the optimizer step, and
                # gates the dense w0/attn_q moment updates, so the fused
                # program's weight-0 padding batches are true no-ops
                # (the reference's defaults COMBINE tile and sub-epochs,
                # cf_config.py:7: tile_size=1024, num_subepoches=2).
                total_loss = self._run_subepochs_fused(buckets, complements)
            else:
                # Per-bucket dispatch (kept as the equivalence oracle;
                # tests flip _fuse_subepochs off to compare).
                for bucket, complement in zip(buckets, complements):
                    total_loss += self._run_pairs(
                        jnp.asarray(bucket),
                        jnp.asarray(complement)
                        if cfg.subepoch_neg_scope == "complement"
                        else None,
                    )
                    if cfg.sgd_mode == SGD_MODE_ACCUM:
                        self.state = zero_grad_accumulators(self.state)
        self.epoch += 1
        return total_loss / max(1, cfg.train_size)

    def _run_subepochs_fused_device(self, perm, counts) -> float:
        """Single-process fused sub-epoch epoch with ON-DEVICE bucketing
        (train_step.make_subepoch_epoch_fn_device): uploads the item
        permutation (I int32) instead of every bucket's packed batches.
        Key draws and geometry match the host-packed path exactly:
        per NON-EMPTY bucket one shuffle key (shuffling modes only) +
        one epoch key; the static (nb, batch) window comes from the same
        grow-only geometry cache."""
        from heat_cf.train.train_step import make_subepoch_epoch_fn_device

        cfg = self.cfg
        s_count = cfg.num_subepochs
        with self.timer.phase("data"):
            ns = [int(c) for c in counts]
            batch, nb = self._subepoch_geometry(ns)
            shuffle_keys, epoch_keys = [], []
            for n in ns:
                if n == 0:
                    shuffle_keys.append(jax.random.key(0))
                    epoch_keys.append(jax.random.key(0))
                    continue
                shuffle_keys.append(
                    self._next_key()
                    if cfg.shuffle_mode != "none"
                    else jax.random.key(0)
                )
                epoch_keys.append(self._next_key())
            perm_j = jnp.asarray(np.asarray(perm, np.int32))
            counts_j = jnp.asarray(np.asarray(counts, np.int32))
            if self._replicated is not None:
                perm_j = jax.device_put(perm_j, self._replicated)
                counts_j = jax.device_put(counts_j, self._replicated)
        fn_key = (s_count, nb, batch)
        cached = getattr(self, "_subep_dev_cache", None)
        if cached is None or cached[0] != fn_key:
            self._subep_dev_cache = (
                fn_key,
                make_subepoch_epoch_fn_device(
                    cfg, self.mesh, s_count, nb, batch
                ),
            )
        fn = self._subep_dev_cache[1]
        with self.timer.phase("f_b"):
            self.state, self.sampler_state, loss_sum = fn(
                self.state,
                self.sampler_state,
                jnp.stack(shuffle_keys),
                jnp.stack(epoch_keys),
                perm_j,
                counts_j,
                self.pairs,
                self.his_items,
                self.his_masks,
            )
            return float(loss_sum)

    def _run_subepochs_fused(self, buckets, complements) -> float:
        """All S sub-epoch buckets in ONE device program
        (train_step.make_subepoch_epoch_fn): ragged buckets pad with
        weight-0 rows/batches, ragged complement pools pad to one width
        with their true sizes riding along (pad entries are never
        sampled). Key draws follow the sequential per-bucket order in
        each regime: single-process draws shuffle+epoch keys per
        NON-EMPTY bucket only (the per-bucket path's _run_pairs returns
        early on empty buckets, drawing nothing); multiprocess draws for
        EVERY bucket (the per-bucket mp path has no early return — empty
        local shards still run _local_batches' compensating draw),
        keeping host key streams aligned. Do not "unify" the two.
        """
        from heat_cf.train.train_step import make_subepoch_epoch_fn

        cfg = self.cfg
        s_count = len(buckets)
        with self.timer.phase("data"):
            keys, arrs = [], []
            if self._multiprocess:
                # SHAPE-STATIC local packing (the same recompile-per-
                # shape hazard as the single-process branch, per host):
                # hosts agree on a grow-only batch-count cap
                # via allgather-max, so every host pads every bucket to
                # identical static shapes and the padded shuffle keeps
                # the real prefix bit-identical (_permute_batches_padded).
                # One key per bucket for shuffling modes — exactly the
                # old per-bucket draw count (empty shards drew a
                # compensating key).
                from jax.experimental import multihost_utils
                from jax.sharding import NamedSharding, PartitionSpec as P

                from heat_cf.parallel.mesh import DATA_AXIS

                d_ax = self._data_axis_size
                nproc = jax.process_count()
                local_batch = max(
                    1, (-(-cfg.batch_size // d_ax) * d_ax) // nproc
                )
                need = max(
                    -(-max(1, int(b.shape[0])) // local_batch)
                    for b in buckets
                )
                all_need = multihost_utils.process_allgather(
                    np.asarray([need])
                )
                need = int(np.max(all_need))
                cached = getattr(self, "_subep_geom_mp", None)
                if (
                    cached is not None
                    and cached[0] == local_batch
                    and cached[1] >= need
                ):
                    local_batch, nb = cached
                else:
                    nb = need + 1 + need // 16
                    self._subep_geom_mp = (local_batch, nb)
                cap_rows = nb * local_batch
                packed = []
                for b in buckets:
                    n = int(b.shape[0])
                    bpad = np.zeros((cap_rows, 2), np.int32)
                    bpad[:n] = b
                    u, p, w = self._shuffle_or_pack_padded(
                        jnp.asarray(bpad), n, nb, local_batch
                    )
                    packed.append(
                        (np.asarray(u), np.asarray(p), np.asarray(w))
                    )
                    keys.append(self._next_key())
                stream_sh = NamedSharding(
                    self.mesh, P(None, None, DATA_AXIS)
                )
                users, pos, weight = (
                    jax.make_array_from_process_local_data(
                        stream_sh,
                        np.stack([a[i] for a in packed]),
                    )
                    for i in range(3)
                )
            else:
                # SHAPE-STATIC packing: bucket sizes jitter every epoch
                # (the item partition is redrawn), and any new concrete
                # shape recompiles its program, a compile far longer than
                # the sub-epoch's compute. Buckets are
                # host-padded to a cached grow-only (nb, batch) cap; the
                # true row count rides as a traced scalar and pad rows
                # are weight-0 (sampler/step no-ops via weight-aware
                # accounting in train_step).
                ns = [int(b.shape[0]) for b in buckets]
                batch, nb = self._subepoch_geometry(ns)
                cap_rows = nb * batch
                for b, n in zip(buckets, ns):
                    if n == 0:
                        arrs.append(
                            (
                                jnp.zeros((nb, batch), jnp.int32),
                                jnp.zeros((nb, batch), jnp.int32),
                                jnp.zeros((nb, batch), jnp.float32),
                            )
                        )
                        keys.append(jax.random.key(0))  # dummy, weight 0
                        continue
                    bpad = np.zeros((cap_rows, 2), np.int32)
                    bpad[:n] = b
                    arrs.append(
                        self._shuffle_or_pack_padded(
                            jnp.asarray(bpad), n, nb, batch
                        )
                    )
                    keys.append(self._next_key())
                users = jnp.stack([a[0] for a in arrs])
                pos = jnp.stack([a[1] for a in arrs])
                weight = jnp.stack([a[2] for a in arrs])
                if self.mesh is not None:
                    from jax.sharding import NamedSharding, PartitionSpec as P

                    from heat_cf.parallel.mesh import DATA_AXIS

                    sh = NamedSharding(self.mesh, P(None, None, DATA_AXIS))
                    users = jax.device_put(users, sh)
                    pos = jax.device_put(pos, sh)
                    weight = jax.device_put(weight, sh)
            c_sizes = [len(c) for c in complements]
            c_max = max(1, max(c_sizes))
            pools_np = np.zeros((s_count, c_max), np.int32)
            for s, c in enumerate(complements):
                if len(c):
                    pools_np[s, : len(c)] = c
                    pools_np[s, len(c):] = c[0]
            pools = jnp.asarray(pools_np)
            sizes = jnp.maximum(
                jnp.asarray(c_sizes, jnp.int32), 1
            )
            if self._replicated is not None and not self._multiprocess:
                pools = jax.device_put(pools, self._replicated)
                sizes = jax.device_put(sizes, self._replicated)
            epoch_keys = jnp.stack(keys)
        if getattr(self, "_subepoch_epoch_fn", None) is None:
            self._subepoch_epoch_fn = make_subepoch_epoch_fn(cfg, self.mesh)
        with self.timer.phase("f_b"):
            self.state, self.sampler_state, loss_sum = (
                self._subepoch_epoch_fn(
                    self.state,
                    self.sampler_state,
                    epoch_keys,
                    users,
                    pos,
                    weight,
                    pools,
                    sizes,
                    self.his_items,
                    self.his_masks,
                )
            )
            return float(loss_sum)

    def train_epochs(self, n: int) -> list[float]:
        """Run ``n`` epochs; returns the mean per-sample loss of each.

        On the single-process unsharded path this is ONE device program
        (``make_multi_epoch_fn``): the per-epoch shuffle, LR schedule,
        cached-pool refresh, and batch scan all live inside an epochs-scan,
        so the fixed per-dispatch cost (and the separately-dispatched
        shuffle) is paid once per call instead of once per epoch. The key
        draws and the
        math match ``n`` sequential ``train_one_epoch`` calls exactly
        (tested in tests/test_engine.py).

        Multi-host runs get the same one-dispatch-per-E-epochs shape:
        fixed streams ("none"/"once") pack once and
        reuse (``_train_epochs_fixed``); "epoch" mode packs each host's
        per-epoch shuffles up front and scans the stacked stream
        (``_train_epochs_stream``). Sub-epoch partitioning (the
        reference's DEFAULT shape) fuses all ``n`` epochs into one
        program too on the single-process path
        (``_train_epochs_subepoch_fused`` — an epochs-scan over the
        on-device-bucketed epoch); multi-host sub-epoch runs loop per
        epoch, each epoch itself ONE dispatch covering all S sub-epochs
        (``_run_subepochs_fused``).
        """
        cfg = self.cfg
        if (
            n > 1
            and cfg.num_subepochs > 1
            and self._fuse_subepochs
            and not self._multiprocess
            and self.mesh is None
            and int(self.pairs.shape[0]) > 0
        ):
            # Sub-epoch configs (the reference's DEFAULT shape) get the
            # same one-dispatch-per-E-epochs amortization: an
            # epochs-scan over the on-device-bucketed epoch program.
            out = self._train_epochs_subepoch_fused(n)
            if out is not None:
                return out
        if n <= 1 or cfg.num_subepochs > 1 or (
            not self._multiprocess and int(self.pairs.shape[0]) == 0
        ):
            return [self.train_one_epoch() for _ in range(n)]
        if cfg.shuffle_mode != "epoch":
            return self._train_epochs_fixed(n)
        if self._multiprocess:
            return self._train_epochs_stream(n)
        if self._multi_epoch_fn is None:
            self._multi_epoch_fn = make_multi_epoch_fn(cfg, self.mesh)
        lrs = jnp.asarray(
            [
                scheduled_lr(
                    cfg.l_r, self.epoch + i, cfg.milestones, cfg.lr_gamma
                )
                for i in range(n)
            ],
            jnp.float32,
        )
        # Same key-draw order as n sequential train_one_epoch calls:
        # per epoch, one shuffle key (_shuffle_or_pack) then one epoch key
        # (_run_pairs).
        shuffle_keys, epoch_keys = [], []
        for _ in range(n):
            shuffle_keys.append(self._next_key())
            epoch_keys.append(self._next_key())
        shuffle_keys = jnp.stack(shuffle_keys)
        epoch_keys = jnp.stack(epoch_keys)
        pairs = self.pairs
        if self._replicated is not None:
            # Mesh mode: small inputs ride replicated so the fused program
            # sees consistent placements against the sharded state.
            shuffle_keys, epoch_keys, lrs, pairs = (
                jax.device_put(x, self._replicated)
                for x in (shuffle_keys, epoch_keys, lrs, pairs)
            )
        with self.timer.phase("f_b"):
            self.state, self.sampler_state, loss_sums = self._multi_epoch_fn(
                self.state,
                self.sampler_state,
                shuffle_keys,
                epoch_keys,
                lrs,
                pairs,
                self.his_items,
                self.his_masks,
            )
            loss_sums = np.asarray(loss_sums)
        self.epoch += n
        return [float(s) / max(1, cfg.train_size) for s in loss_sums]

    def _train_epochs_subepoch_fused(self, n: int):
        """``n`` sub-epoch epochs as ONE device program
        (train_step.make_subepoch_multi_epoch_fn): the ``--fused-epochs``
        amortization at the reference's DEFAULT config shape. Key/perm
        draws match ``n`` sequential ``train_one_epoch`` calls exactly
        (numpy perms and jax keys are independent streams). Returns None
        (rng rewound, nothing consumed beyond the rewind) when the
        epoch-invariant-geometry precondition fails, so the caller falls
        back to per-epoch dispatch."""
        from heat_cf.train.train_step import make_subepoch_multi_epoch_fn

        cfg = self.cfg
        with self.timer.phase("data"):
            prep = self._subepoch_multi_prep(n)
            if prep is None:
                return None
            s_count, batch, nb, perms, counts_list = prep
            sks, eks = self._subepoch_draw_keys(counts_list)
            lrs = jnp.asarray(
                [
                    scheduled_lr(
                        cfg.l_r, self.epoch + i, cfg.milestones,
                        cfg.lr_gamma,
                    )
                    for i in range(n)
                ],
                jnp.float32,
            )
        fn_key = (s_count, nb, batch)
        cached = getattr(self, "_subep_multi_cache", None)
        if cached is None or cached[0] != fn_key:
            self._subep_multi_cache = (
                fn_key,
                make_subepoch_multi_epoch_fn(
                    cfg, self.mesh, s_count, nb, batch
                ),
            )
        fn = self._subep_multi_cache[1]
        with self.timer.phase("f_b"):
            self.state, self.sampler_state, loss_sums = fn(
                self.state,
                self.sampler_state,
                sks,
                eks,
                lrs,
                jnp.asarray(np.stack(perms)),
                jnp.asarray(np.stack(counts_list).astype(np.int32)),
                self.pairs,
                self.his_items,
                self.his_masks,
            )
            loss_sums = np.asarray(loss_sums)
        self.epoch += n
        return [
            float(s) / max(1, cfg.train_size) for s in loss_sums
        ]

    def _train_epochs_fixed(self, n: int) -> list[float]:
        """Fused multi-epoch path for fixed batch streams (shuffle_mode
        "none"/"once"): batches are packed once, the dedup maps ride
        along, and n epochs run as ONE device program. Key draws match n
        sequential train_one_epoch calls exactly ("once": one shuffle key
        + one epoch key per epoch; "none": one epoch key)."""
        from heat_cf.train.train_step import make_multi_epoch_fixed_fn

        cfg = self.cfg
        with self.timer.phase("data"):
            pairs = self.pairs
            if self._multiprocess:
                # Global (nb, B) arrays assembled from per-host packs with
                # batch-count agreement (the per-epoch path's assembly,
                # reused once — the stream is fixed across epochs).
                users, pos, weight = self._make_batches(pairs)
                dedup = self._dedup_mp_cached(pairs)
            else:
                nloc = int(pairs.shape[0])
                batch = min(cfg.batch_size, max(1, nloc))
                batch = (
                    -(-batch // self._data_axis_size) * self._data_axis_size
                )
                num_batches = -(-nloc // batch)
                users, pos, weight = self._shuffle_or_pack(
                    pairs, num_batches, batch
                )
                dedup = self._history_dedup(pairs, users)
                if self._batch_sharding is not None:
                    users = jax.device_put(users, self._batch_sharding)
                    pos = jax.device_put(pos, self._batch_sharding)
                    weight = jax.device_put(weight, self._batch_sharding)
        if getattr(self, "_multi_epoch_fixed_fn", None) is None:
            self._multi_epoch_fixed_fn = make_multi_epoch_fixed_fn(
                cfg, self.mesh
            )
        lrs = jnp.asarray(
            [
                scheduled_lr(
                    cfg.l_r, self.epoch + i, cfg.milestones, cfg.lr_gamma
                )
                for i in range(n)
            ],
            jnp.float32,
        )
        epoch_keys = []
        for i in range(n):
            if cfg.shuffle_mode == "once" and i > 0:
                # Sequential parity: each train_one_epoch call would draw
                # (and discard, cache hit) one shuffle key.
                self._next_key()
            epoch_keys.append(self._next_key())
        epoch_keys = jnp.stack(epoch_keys)
        if self._replicated is not None:
            # Multi-process: keys stay uncommitted (jit replicates them;
            # device_put of key arrays to a non-addressable replicated
            # sharding is rejected by jax).
            if not self._multiprocess:
                epoch_keys = jax.device_put(epoch_keys, self._replicated)
            lrs = jax.device_put(lrs, self._replicated)
        with self.timer.phase("f_b"):
            self.state, self.sampler_state, loss_sums = (
                self._multi_epoch_fixed_fn(
                    self.state,
                    self.sampler_state,
                    epoch_keys,
                    lrs,
                    users,
                    pos,
                    weight,
                    self.his_items,
                    self.his_masks,
                    dedup[0] if dedup else None,
                    dedup[1] if dedup else None,
                    dedup[2]
                    if dedup and cfg.aggregator != "mean"
                    else None,
                )
            )
            loss_sums = np.asarray(loss_sums)
        self.epoch += n
        return [float(s) / max(1, cfg.train_size) for s in loss_sums]

    def _train_epochs_stream(self, n: int) -> list[float]:
        """Fused multi-epoch path for MULTIPROCESS per-epoch-shuffled
        streams (shuffle_mode "epoch"): each host shuffles+packs its local
        pairs for all n epochs up front — the same key draws, batch-count
        agreement, and local-batch geometry as n sequential
        train_one_epoch calls — then the stacked (E, nb, B) global batch
        arrays are assembled once and n epochs run as ONE device program
        (train_step.make_multi_epoch_stream_fn)."""
        from heat_cf.train.train_step import make_multi_epoch_stream_fn

        cfg = self.cfg
        with self.timer.phase("data"):
            epoch_users, epoch_pos, epoch_weight, epoch_keys = [], [], [], []
            for _ in range(n):
                # Sequential order: one shuffle key (inside
                # _local_batches), then one epoch key.
                u, p, w = self._local_batches(self.pairs)
                epoch_users.append(np.asarray(u))
                epoch_pos.append(np.asarray(p))
                epoch_weight.append(np.asarray(w))
                epoch_keys.append(self._next_key())
            from jax.sharding import NamedSharding, PartitionSpec as P

            from heat_cf.parallel.mesh import DATA_AXIS

            stream_sh = NamedSharding(self.mesh, P(None, None, DATA_AXIS))
            users, pos, weight = (
                jax.make_array_from_process_local_data(
                    stream_sh, np.stack(a)
                )
                for a in (epoch_users, epoch_pos, epoch_weight)
            )
        if getattr(self, "_multi_epoch_stream_fn", None) is None:
            self._multi_epoch_stream_fn = make_multi_epoch_stream_fn(
                cfg, self.mesh
            )
        lrs = jnp.asarray(
            [
                scheduled_lr(
                    cfg.l_r, self.epoch + i, cfg.milestones, cfg.lr_gamma
                )
                for i in range(n)
            ],
            jnp.float32,
        )
        epoch_keys = jnp.stack(epoch_keys)
        # Keys stay uncommitted (device_put of key arrays to a replicated
        # multi-process sharding is rejected by jax; jit replicates
        # uncommitted host-local args — every host computed the same keys
        # from the same seed, matching the _run_pairs convention).
        lrs = jax.device_put(lrs, self._replicated)
        with self.timer.phase("f_b"):
            self.state, self.sampler_state, loss_sums = (
                self._multi_epoch_stream_fn(
                    self.state,
                    self.sampler_state,
                    epoch_keys,
                    lrs,
                    users,
                    pos,
                    weight,
                    self.his_items,
                    self.his_masks,
                )
            )
            loss_sums = np.asarray(loss_sums)
        self.epoch += n
        return [float(s) / max(1, cfg.train_size) for s in loss_sums]

    def run_epochs_with_eval(
        self,
        epochs: int,
        eval_interval: int,
        metrics: Optional[Sequence[str]] = None,
        user_tile: int = 512,
        fused: bool = True,
    ) -> tuple[list[float], list[dict]]:
        """The reference's full deployment shape (cf/main.py:106-124):
        ``epochs`` epochs with a ranking evaluation after epoch ``e``
        whenever ``e > 0 and e % eval_interval == 0``.

        On the single-process unsharded path the WHOLE run — every epoch
        scan and every tiled top-k + on-device metric reduction —
        executes as ONE device program: per-epoch shuffling without
        sub-epochs through train/run.make_run_fn, and sub-epoch
        partitioning (the reference's DEFAULT shape, cf_config.py:7)
        through make_run_fn_subepoch over the on-device-bucketed epoch
        program. Only per-epoch loss scalars and per-eval metric values
        reach the host. Key draws match sequential ``train_one_epoch``
        calls exactly, so the loss trajectory is identical to the
        unfused shape (tested). Everything else (mesh/multi-host, fixed
        streams without sub-epochs, scatter-mask eval geometries,
        ``fused=False``) falls back to ``train_epochs`` segments +
        ``evaluate`` at each boundary.

        Returns (per-epoch mean losses, evals) where evals entries are
        {"epoch": e, metric: value, ...} in schedule order.
        """
        from heat_cf.train.run import (
            make_run_fn,
            make_run_fn_subepoch,
            reference_schedule,
        )

        cfg = self.cfg
        metrics = list(metrics if metrics is not None else cfg.metrics)
        # Schedule anchored at the ABSOLUTE current epoch so a resumed
        # run evals at the same epochs as an uninterrupted one (and as
        # the unfused CLI loop, which keys off engine.epoch).
        start0 = self.epoch
        segments = reference_schedule(epochs, eval_interval, start0)
        base_ok = (
            fused
            and not self._multiprocess
            and self.mesh is None
            and self.test_data is not None
            and int(self.pairs.shape[0]) > 0
        )
        eligible = (
            base_ok
            and cfg.shuffle_mode == "epoch"
            and cfg.num_subepochs <= 1
        )
        # Sub-epoch configs (the reference's DEFAULT shape,
        # cf_config.py:7) fuse through the on-device-bucketed epoch
        # program instead; any shuffle mode (the per-epoch device path
        # treats them identically at sub-epoch granularity).
        sub_eligible = (
            base_ok and cfg.num_subepochs > 1 and self._fuse_subepochs
        )
        sub_prep = None
        if eligible or sub_eligible:
            self._ensure_evaluator(user_tile)
            ok = self._evaluator.mask_bits is not None
            eligible = eligible and ok
            sub_eligible = sub_eligible and ok
        if sub_eligible:
            sub_prep = self._subepoch_multi_prep(epochs)
            sub_eligible = sub_prep is not None
        if not (eligible or sub_eligible):
            losses: list[float] = []
            evals: list[dict] = []
            done = 0
            for seg, do_eval in segments:
                losses.extend(self.train_epochs(seg))
                done += seg
                if do_eval:
                    evals.append(
                        {
                            "epoch": start0 + done - 1,
                            **self.evaluate(metrics, user_tile=user_tile),
                        }
                    )
            return losses, evals

        specs = tuple(parse_metric(m) for m in metrics)
        max_k = max(k for _, k in specs)
        ev = self._evaluator
        lrs = jnp.asarray(
            [
                scheduled_lr(
                    cfg.l_r, self.epoch + i, cfg.milestones, cfg.lr_gamma
                )
                for i in range(epochs)
            ],
            jnp.float32,
        )
        if sub_eligible:
            s_count, batch, nb, perms, counts_list = sub_prep
            fn_key = (
                segments, specs, max_k, user_tile, s_count, nb, batch,
            )
            cached = getattr(self, "_run_fn_subep_cache", None)
            if cached is None or cached[0] != fn_key:
                fn = make_run_fn_subepoch(
                    cfg,
                    segments,
                    specs,
                    max_k,
                    user_tile,
                    ev.num_tiles,
                    ev._pad_items,
                    s_count,
                    nb,
                    batch,
                )
                self._run_fn_subep_cache = (fn_key, fn)
            fn = self._run_fn_subep_cache[1]
            sks, eks = self._subepoch_draw_keys(counts_list)
            with self.timer.phase("f_b"):
                self.state, self.sampler_state, loss_sums, mvals = fn(
                    self.state,
                    self.sampler_state,
                    sks,
                    eks,
                    lrs,
                    jnp.asarray(np.stack(perms)),
                    jnp.asarray(
                        np.stack(counts_list).astype(np.int32)
                    ),
                    self.pairs,
                    self.his_items,
                    self.his_masks,
                    ev.mask_bits,
                    *self._truth_dev,
                )
                loss_sums = np.asarray(loss_sums)
                mvals = np.asarray(mvals)
        else:
            fn_key = (segments, specs, max_k, user_tile)
            cached = getattr(self, "_run_fn_cache", None)
            if cached is None or cached[0] != fn_key:
                fn = make_run_fn(
                    cfg,
                    segments,
                    specs,
                    max_k,
                    user_tile,
                    ev.num_tiles,
                    ev._pad_items,
                )
                self._run_fn_cache = (fn_key, fn)
            fn = self._run_fn_cache[1]
            shuffle_keys, epoch_keys = [], []
            for _ in range(epochs):
                shuffle_keys.append(self._next_key())
                epoch_keys.append(self._next_key())
            with self.timer.phase("f_b"):
                self.state, self.sampler_state, loss_sums, mvals = fn(
                    self.state,
                    self.sampler_state,
                    jnp.stack(shuffle_keys),
                    jnp.stack(epoch_keys),
                    lrs,
                    self.pairs,
                    self.his_items,
                    self.his_masks,
                    ev.mask_bits,
                    *self._truth_dev,
                )
                loss_sums = np.asarray(loss_sums)
                mvals = np.asarray(mvals)
        self.epoch += epochs
        losses = [float(s) / max(1, cfg.train_size) for s in loss_sums]
        evals = []
        i = 0
        done = 0
        for seg, do_eval in segments:
            done += seg
            if do_eval:
                evals.append(
                    {
                        "epoch": start0 + done - 1,
                        **{
                            m: float(v)
                            for m, v in zip(metrics, mvals[i])
                        },
                    }
                )
                i += 1
        return losses, evals

    def _ensure_evaluator(self, user_tile: int) -> None:
        """Build (or rebuild for a new tile width) the cached
        TiledEvaluator and device-resident truth tensors."""
        if self._evaluator is None or self._evaluator.user_tile != user_tile:
            self._evaluator = TiledEvaluator(
                self.train_data.pairs,
                self.cfg.num_users,
                user_tile=user_tile,
                num_items=self.cfg.num_items,
            )
            # Truth tensors ride on device alongside the mask cache so
            # metric evaluation never downloads the (U, k) id matrix.
            self._truth_dev = jax.tree.map(
                jnp.asarray, pad_truth(self.test_data.user_items)
            )

    # ------------------------------------------------------------------
    def evaluate(
        self,
        metrics: Optional[Sequence[str]] = None,
        user_tile: int = 512,
        aggregate_users: bool = False,
    ) -> dict[str, float]:
        """Tiled on-device exact top-k + the full metric library.

        aggregate_users: score with freshly-aggregated user embeddings
        (gamma * u + (1-gamma) * mean(history) @ w0) instead of the raw user
        table — a live version of the reference's commented-out ``evaluate1``
        (engine.cpp:402-451). With the default False, scoring uses the raw
        table like ``evaluate0`` (whose rows were already aggregated during
        training by the write-back).
        """
        if self.test_data is None:
            raise ValueError("no test_data provided")
        metrics = list(metrics if metrics is not None else self.cfg.metrics)
        max_k = max(parse_metric(m)[1] for m in metrics)
        if self._multiprocess:
            return self._evaluate_multiprocess(
                metrics,
                max_k,
                user_tile,
                aggregate_users,
            )
        user_emb = self.state.user_emb[: self.cfg.num_users]
        if aggregate_users:
            user_emb = aggregate_history(
                user_emb,
                self._pooled_history()[: self.cfg.num_users],
                self.state.w0,
                self.cfg.gamma,
            )
        with self.timer.phase("eval"):
            self._ensure_evaluator(user_tile)
            _, top_ids = self._evaluator.topk(
                user_emb,
                self.state.item_emb[: self.cfg.num_items],
                max_k,
                device=True,
            )
            return evaluate_metrics_device(
                metrics, top_ids, *self._truth_dev
            )

    def _mp_eval_tensors(self):
        """Build (once) the global sharded eval tensors: the packed
        train-pair bitmask (item axis padded to the mesh's sharded width,
        pad bits hard-masked) and the padded truth, each row-sharded over
        the data axis alongside the user table."""
        if getattr(self, "_mp_eval_cache", None) is not None:
            return self._mp_eval_cache
        from jax.experimental import multihost_utils
        from jax.sharding import NamedSharding, PartitionSpec as P

        from heat_cf.evaluation.evaluator import (
            pack_train_bits,
            sharded_pad_items,
        )
        from heat_cf.parallel.mesh import DATA_AXIS

        cfg = self.cfg
        start, end = user_range_bounds(
            cfg.num_users, jax.process_count(), jax.process_index()
        )
        u_loc = end - start
        local_pairs = np.asarray(self.train_data.pairs).copy()
        if len(local_pairs):
            local_pairs[:, 0] -= start
        bits_local = pack_train_bits(
            local_pairs, u_loc, cfg.num_items,
            pad_items=sharded_pad_items(self.mesh, cfg.num_items),
        )
        truth_local, len_local = pad_truth(self.test_data.user_items)
        if truth_local.shape[0] < u_loc:  # trailing users without test rows
            pad = u_loc - truth_local.shape[0]
            truth_local = np.concatenate(
                [truth_local, np.full((pad, truth_local.shape[1]), -1,
                                      np.int32)]
            )
            len_local = np.concatenate([len_local, np.zeros(pad, np.int32)])
        truth_local = truth_local[:u_loc]
        len_local = len_local[:u_loc]
        # All hosts must agree on the truth pad width.
        widths = multihost_utils.process_allgather(
            np.asarray([truth_local.shape[1]])
        )
        width = int(np.max(widths))
        if truth_local.shape[1] < width:
            truth_local = np.concatenate(
                [
                    truth_local,
                    np.full(
                        (u_loc, width - truth_local.shape[1]), -1, np.int32
                    ),
                ],
                axis=1,
            )
        row_sh = NamedSharding(self.mesh, P(DATA_AXIS, None))
        vec_sh = NamedSharding(self.mesh, P(DATA_AXIS))
        self._mp_eval_cache = (
            jax.make_array_from_process_local_data(row_sh, bits_local),
            jax.make_array_from_process_local_data(row_sh, truth_local),
            jax.make_array_from_process_local_data(vec_sh, len_local),
        )
        return self._mp_eval_cache

    def _mp_padded_items(self):
        """The live item table with its row axis zero-padded on device to
        ``sharded_pad_items`` width, laid out P("model", None) for the
        shard_map top-k. One sharded concatenate per evaluation —
        O(I*d / n_devices) per device, vs the allgather fallback's O(I*d)
        PER HOST — and a no-op when the geometry already divides."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from heat_cf.evaluation.evaluator import sharded_pad_items
        from heat_cf.parallel.mesh import MODEL_AXIS

        pad_items = sharded_pad_items(self.mesh, self.cfg.num_items)
        pad = pad_items - int(self.state.item_emb.shape[0])
        sh = NamedSharding(self.mesh, P(MODEL_AXIS, None))
        fn = getattr(self, "_item_pad_fn", None)
        if fn is None:
            if pad == 0:
                fn = jax.jit(lambda t: t, out_shardings=sh)
            else:
                fn = jax.jit(
                    lambda t: jnp.concatenate(
                        [t, jnp.zeros((pad, t.shape[1]), t.dtype)]
                    ),
                    out_shardings=sh,
                )
            self._item_pad_fn = fn
        return fn(self.state.item_emb)

    def _evaluate_multiprocess(
        self,
        metrics: Sequence[str],
        max_k: int,
        user_tile: int,
        aggregate_users: bool = False,
    ) -> dict[str, float]:
        """Distributed ranking eval: shard_map top-k + on-device global
        metric reduction.

        The reference evaluates per rank against the global item table and
        never combines metrics (SURVEY.md section 3.3 flags this as a gap).
        Here nothing is ever materialized whole: each (data, model) shard
        scores its user rows against its LOCAL item rows, per-shard top-k
        candidates are merged with one k*n_model all_gather
        (evaluator.sharded_topk), and the metric averages are exact global
        on-device reductions (metrics.device_metric_sums) — only
        len(metrics)+1 scalars reach each host.

        Geometry-universal: the item axis is padded on device to
        ``sharded_pad_items`` (one O(I*d/n_devices) sharded copy per eval —
        zero rows, pad bits hard-masked in the cached bitmask), so ANY
        ``num_items`` takes this path; the O(I*d)-per-host allgather
        fallback remains only for ``k`` > items/shard.
        """
        from heat_cf.evaluation.evaluator import (
            sharded_topk,
            sharded_topk_supported,
        )
        from heat_cf.evaluation.metrics import device_metric_sums

        cfg = self.cfg
        user_arr = self.state.user_emb
        if aggregate_users:
            user_arr = aggregate_history(
                user_arr, self._pooled_history(), self.state.w0, cfg.gamma
            )
        if not sharded_topk_supported(
            self.mesh, cfg.num_items, max_k, cfg.num_users
        ):
            return self._evaluate_multiprocess_allgather(
                metrics, max_k, user_tile, user_arr
            )
        bits, truth, truth_len = self._mp_eval_tensors()
        _, top_ids = sharded_topk(
            self.mesh,
            user_arr,
            self._mp_padded_items(),
            bits,
            max_k,
            user_chunk=user_tile,
        )
        sums = device_metric_sums(metrics, top_ids, truth, truth_len)
        denom = max(float(sums[-1]), 1.0)
        return {m: float(sums[i]) / denom for i, m in enumerate(metrics)}

    def _evaluate_multiprocess_allgather(
        self,
        metrics: Sequence[str],
        max_k: int,
        user_tile: int,
        user_arr,
    ) -> dict[str, float]:
        """Fallback for the geometries the shard_map path cannot cover —
        since the item axis is padded (sharded_pad_items), that is only
        k > padded items/shard or a user axis that cannot split over the
        data axis: each host allgathers the item table — O(I*d) per host
        — and scores locally. Metric sums are combined exactly across
        hosts."""
        from jax.experimental import multihost_utils

        item_emb = multihost_utils.process_allgather(
            self.state.item_emb, tiled=True
        )
        user_local = _process_local_rows(user_arr)
        start, _ = user_range_bounds(
            self.cfg.num_users, jax.process_count(), jax.process_index()
        )
        local_pairs = np.asarray(self.train_data.pairs).copy()
        if len(local_pairs):
            local_pairs[:, 0] -= start
        ev = TiledEvaluator(
            local_pairs,
            user_local.shape[0],
            user_tile=user_tile,
            num_items=self.cfg.num_items,
        )
        _, top_ids = ev.topk(user_local, item_emb, max_k)
        local = evaluate_metrics(metrics, top_ids, self.test_data.user_items)
        count = sum(1 for t in self.test_data.user_items if len(t))
        sums = np.asarray([local[m] * count for m in metrics] + [count])
        totals = multihost_utils.process_allgather(sums).reshape(
            jax.process_count(), -1
        ).sum(axis=0)
        denom = max(totals[-1], 1.0)
        return {m: float(totals[i] / denom) for i, m in enumerate(metrics)}

    def performance_breakdown(self) -> str:
        """Percentage tree over host-visible phases (engine.cpp:22-65)."""
        return performance_breakdown(self.timer)

    def evaluate0(self) -> np.ndarray:
        """Reference-parity API: dense sim matrix (engine.cpp:388-400)."""
        st = self.unpadded_state()
        return full_sim_matrix(st.user_emb, st.item_emb)
