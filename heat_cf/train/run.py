"""The reference's full deployment shape as ONE device program.

The reference's actual run is train-with-interleaved-eval
(cf/main.py:106-124): ``epochs`` epochs of ``train_one_epoch``, and after
epoch ``e`` (0-based) whenever ``e > 0 and e % eval_interval == 0`` a full
ranking evaluation (``evaluate0`` GEMM + top-k metrics). heat_cf measures
that shape two ways:

* unfused — ``Engine.train_epochs`` segments between evals plus
  ``Engine.evaluate`` at each boundary (one dispatch per segment + one per
  eval);
* fused — this module: the WHOLE run (every epoch scan, every tiled
  top-k + metric reduction) as one jitted device program. Segments are
  unrolled in Python at trace time (there are at most a handful of eval
  boundaries), each segment is a ``lax.scan`` over its epochs, and each
  eval boundary inlines the tiled evaluator
  (evaluation.evaluator.topk_all_tiles_impl, packed-bitmask mode) and the
  on-device metric reduction (evaluation.metrics._device_metrics_compute)
  against pre-uploaded truth tensors. Only the per-epoch loss scalars and
  the (n_evals, n_metrics) metric values reach the host.

Single-process, unsharded engines only (the multi-host path keeps per-epoch
host packing; Engine.run_epochs_with_eval falls back automatically).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from heat_cf.config import CFConfig
from heat_cf.evaluation.evaluator import topk_all_tiles_impl
from heat_cf.evaluation.metrics import _device_metrics_compute
from heat_cf.train.train_step import (
    Batch,
    _refresh_pools,
    make_subepoch_epoch_impl,
    shuffle_pairs,
    train_step,
)


def _make_eval_state(
    cfg: CFConfig,
    specs: tuple[tuple[str, int], ...],
    max_k: int,
    user_tile: int,
    num_tiles: int,
    pad_items: int,
):
    """The inlined eval boundary shared by every fused run program: tiled
    packed-bitmask exact top-k (evaluator geometry) + on-device metric
    reduction. Raw-table scoring like evaluate0 (engine.cpp:388-400);
    column padding (emb_pad) is zero in both tables so scores are
    unaffected."""

    def eval_state(state, mask_bits, truth, truth_len):
        u = state.user_emb[: cfg.num_users].astype(jnp.float32)
        items = state.item_emb[: cfg.num_items].astype(jnp.float32)
        if pad_items > cfg.num_items:
            items = jnp.concatenate(
                [
                    items,
                    jnp.zeros(
                        (pad_items - cfg.num_items, items.shape[1]),
                        items.dtype,
                    ),
                ]
            )
        pad_rows = num_tiles * user_tile - cfg.num_users
        if pad_rows:
            u = jnp.concatenate(
                [u, jnp.zeros((pad_rows, u.shape[1]), u.dtype)]
            )
        user_tiles = u.reshape(num_tiles, user_tile, -1)
        dummy = jnp.zeros((num_tiles, 1), jnp.int32)
        _, ids = topk_all_tiles_impl(
            user_tiles, items, dummy, dummy, mask_bits,
            k=max_k,
        )
        ids = ids.reshape(num_tiles * user_tile, max_k)[: cfg.num_users]
        return _device_metrics_compute(ids, truth, truth_len, specs)

    return eval_state


def make_run_fn(
    cfg: CFConfig,
    segments: tuple[tuple[int, bool], ...],
    specs: tuple[tuple[str, int], ...],
    max_k: int,
    user_tile: int,
    num_tiles: int,
    pad_items: int,
):
    """Build the fused run program.

    Args:
      segments: ((n_epochs, eval_after), ...) — the reference loop's
        epoch/eval schedule, sum(n_epochs) = total epochs.
      specs: parsed metric specs ((name, k), ...) for the on-device
        metric reduction at each eval boundary.
      max_k: ranks ranked at each eval (>= every spec's k).
      user_tile/num_tiles: the evaluator's user tiling geometry.
      pad_items: item axis width of the packed mask (multiple of 128,
        evaluator geometry — pad bits pre-set, pad embedding rows zero).

    Returns f(state, sampler_state, shuffle_keys (E,), epoch_keys (E,),
              lrs (E,), pairs (N, 2), his_items, his_masks,
              mask_bits (num_tiles, user_tile, pad_items/32),
              truth (U, L), truth_len (U,))
        -> (state, sampler_state, loss_sums (E,),
            metric_vals (n_evals, len(specs)))
    State and sampler state are donated. Key draws match ``train_epochs``
    / sequential ``train_one_epoch`` calls exactly (evals draw nothing),
    so the loss trajectory is identical to the unfused shape.
    """
    eval_state = _make_eval_state(
        cfg, specs, max_k, user_tile, num_tiles, pad_items
    )

    def run_fn(
        state,
        sampler_state,
        shuffle_keys,
        epoch_keys,
        lrs,
        pairs,
        his_items,
        his_masks,
        mask_bits,
        truth,
        truth_len,
    ):
        n = pairs.shape[0]
        batch = min(cfg.batch_size, max(1, n))
        num_batches = -(-n // batch)
        total = num_batches * batch
        weight = (
            (jnp.arange(total) < n).astype(jnp.float32)
            .reshape(num_batches, batch)
        )

        def epoch_body(carry, xs):
            state, sampler_state = carry
            k_shuf, k_epoch, lr = xs
            state = state.replace(lr=lr)
            su, sp = shuffle_pairs(k_shuf, pairs, total)
            users = su.reshape(num_batches, batch)
            pos = sp.reshape(num_batches, batch)
            bkeys = jax.random.split(k_epoch, num_batches)
            user_means = _refresh_pools(cfg, state, his_items, his_masks)

            def body(c, bxs):
                st, ss = c
                k, u, p, w = bxs
                st, ss, loss = train_step(
                    st, ss, k, Batch(u, p, w), his_items, his_masks, cfg,
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

        loss_segs, mvals = [], []
        e0 = 0
        for seg, do_eval in segments:
            (state, sampler_state), seg_losses = jax.lax.scan(
                epoch_body,
                (state, sampler_state),
                (
                    shuffle_keys[e0 : e0 + seg],
                    epoch_keys[e0 : e0 + seg],
                    lrs[e0 : e0 + seg],
                ),
            )
            loss_segs.append(seg_losses)
            e0 += seg
            if do_eval:
                mvals.append(
                    eval_state(state, mask_bits, truth, truth_len)
                )
        metric_vals = (
            jnp.stack(mvals)
            if mvals
            else jnp.zeros((0, len(specs)), jnp.float32)
        )
        return state, sampler_state, jnp.concatenate(loss_segs), metric_vals

    return jax.jit(run_fn, donate_argnums=(0, 1))


def make_run_fn_subepoch(
    cfg: CFConfig,
    segments: tuple[tuple[int, bool], ...],
    specs: tuple[tuple[str, int], ...],
    max_k: int,
    user_tile: int,
    num_tiles: int,
    pad_items: int,
    s_count: int,
    nb: int,
    batch: int,
):
    """The fused run program for SUB-EPOCH configs — the reference's
    actual DEFAULT deployment shape (cf_config.py:7 combines
    tile_size=1024 with num_subepoches=2; cf/main.py:106-124 interleaves
    evals): every epoch is the on-device-bucketed sub-epoch program
    (train_step.make_subepoch_epoch_impl), inlined into per-segment
    epoch scans with the tiled top-k + metric reduction at each eval
    boundary — ONE device program for the whole schedule.

    Host-drawn randomness rides in as stacked per-epoch tensors: the
    item permutations (E, I) — host rng preserved for per-bucket-oracle
    parity — per-bucket counts (E, S), and per-bucket shuffle/epoch keys
    (E, S). Key draws match sequential ``train_one_epoch`` calls exactly
    (numpy perms and jax keys are independent streams, so batching the
    perm draws first changes neither sequence).

    Returns f(state, sampler_state, shuffle_keys (E, S), epoch_keys
              (E, S), lrs (E,), perms (E, I), counts (E, S),
              pairs (N, 2), his_items, his_masks, mask_bits, truth,
              truth_len)
        -> (state, sampler_state, loss_sums (E,),
            metric_vals (n_evals, len(specs)))
    State and sampler state are donated.
    """
    epoch_impl = make_subepoch_epoch_impl(cfg, None, s_count, nb, batch)
    eval_state = _make_eval_state(
        cfg, specs, max_k, user_tile, num_tiles, pad_items
    )

    def run_fn(
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
        mask_bits,
        truth,
        truth_len,
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

        loss_segs, mvals = [], []
        e0 = 0
        for seg, do_eval in segments:
            (state, sampler_state), seg_losses = jax.lax.scan(
                epoch_body,
                (state, sampler_state),
                (
                    shuffle_keys[e0 : e0 + seg],
                    epoch_keys[e0 : e0 + seg],
                    lrs[e0 : e0 + seg],
                    perms[e0 : e0 + seg],
                    counts[e0 : e0 + seg],
                ),
            )
            loss_segs.append(seg_losses)
            e0 += seg
            if do_eval:
                mvals.append(
                    eval_state(state, mask_bits, truth, truth_len)
                )
        metric_vals = (
            jnp.stack(mvals)
            if mvals
            else jnp.zeros((0, len(specs)), jnp.float32)
        )
        return state, sampler_state, jnp.concatenate(loss_segs), metric_vals

    return jax.jit(run_fn, donate_argnums=(0, 1))


def reference_schedule(
    epochs: int, eval_interval: int, start_epoch: int = 0
) -> tuple[tuple[int, bool], ...]:
    """The reference driver's epoch/eval schedule (cf/main.py:106-124):
    after epoch ``e`` (0-based), evaluate iff ``e > 0 and
    e % eval_interval == 0``. Returns ((n_epochs, eval_after), ...) with
    n_epochs summing to ``epochs``.

    ``start_epoch`` anchors the schedule at ABSOLUTE epoch indices so a
    checkpoint-resumed run evaluates at the same epochs as an
    uninterrupted one (resume at epoch 3 of 10 with interval 2 still
    evals after epochs 4, 6, 8 — not 5, 7, 9)."""
    segments: list[tuple[int, bool]] = []
    run = 0
    for e in range(start_epoch, start_epoch + epochs):
        run += 1
        if e > 0 and e % eval_interval == 0:
            segments.append((run, True))
            run = 0
    if run:
        segments.append((run, False))
    return tuple(segments)
