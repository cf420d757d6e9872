"""Negative samplers, on-device.

The reference implements two strategies behind a selector
(engine.cpp:194-201):

* ``UniformRandomNegativeSampler`` — uniform item ids; the ``ignore_pos``
  variant redraws a slot that hits the positive
  (uniform_random_negative_sampler.cpp:10-36; the reference keeps the
  slot's previous stale value instead of redrawing — distributionally this
  is a resample, which is what the vectorized version does);
* ``RandomTileNegativeSampler`` — HEAT's cache-tiling sampler
  (random_tile_negative_sampler.cpp:11-57): a tile of ``tile_size`` random
  item ids refreshed every ``refresh_interval`` samples; draws index into
  the tile. On CPU this keeps negative reads cache-resident; on an
  accelerator the same strategy keeps the per-step negative gather
  working set small and turns negative scoring into one (B, T) matmul.

RNG: the reference uses mt19937_64 seeded ad hoc (engine.cpp:192); here a
``jax.random`` key tree gives deterministic, reproducible streams (matching
distributions, not bit-streams — SURVEY.md section 7 "RNG parity").

State is an explicit pytree (`SamplerState`) threaded through the epoch scan
so the tile and iteration counter live on device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from heat_cf.config import CFConfig, NEG_SAMPLER_TILE


class NegSample(NamedTuple):
    """A batch of negatives, with tile structure when available.

    ids: (B, K) negative item ids.
    tile: (T,) the tile's item ids, or None for the uniform sampler.
    tile_idx: (B, K) indices into the tile, or None.

    The tile structure lets the train step keep negative gathers and
    gradient scatters inside a T-row working set (HEAT's cache-tiling
    insight, mapped to a small device working set instead of L2).
    """

    ids: jnp.ndarray
    tile: Optional[jnp.ndarray]
    tile_idx: Optional[jnp.ndarray]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SamplerState:
    """Device-resident sampler state.

    tile: (tile_size,) int32 current negative tile (tile sampler only;
      kept as a size-1 dummy for the uniform sampler so the pytree shape
      is static across modes).
    iterations: int32 count of *samples* drawn so far (the reference
      counts per ``sampling()`` call, random_tile_negative_sampler.cpp:44).
    """

    tile: jax.Array
    iterations: jax.Array

    def replace(self, **changes) -> "SamplerState":
        return dataclasses.replace(self, **changes)


# Alpha/beta working-set split of HEAT's tile-tuning algorithm (paper
# Alg. 1): beta of the budget goes to the negative tile, alpha is reserved
# for the streaming data.
TILE_TUNE_ALPHA = 0.15
TILE_TUNE_BETA = 0.85
# Per-step budget for the (B, T) score/count working set. HEAT sizes the
# tile to beta x last-level cache; the device analog is the per-step (B, T)
# score + count matrices the fused tile path materializes, kept so their
# device-memory traffic stays a small multiple of the embedding gathers.
# 32 MB reproduces the reference's shipped tile_size=512 at the AmazonBooks
# config (B=8192, f32 scores + counts). The budget was set on the previous
# accelerator and is not re-derived on the GPU yet (ROADMAP).
TILE_SCORE_BUDGET_BYTES = 32 * 1024 * 1024
# Expected draws landing on each tile slot before a refresh; ties
# refresh_interval to tile_size the way the reference configs do
# (tile 512 x 16 = refresh 8192 in AmazonBooks's config0.yaml).
TILE_DRAWS_PER_SLOT = 16


def derive_tile_params(
    cfg: CFConfig, budget_bytes: int = TILE_SCORE_BUDGET_BYTES
) -> tuple[int, int]:
    """Auto-tune (tile_size, refresh_interval) — HEAT paper Alg. 1, for a
    device step.

    The reference tunes the tile to fit beta = 85% of the LLC (alpha = 15%
    reserved for streamed data) so negative reads stay cache-resident. On
    an accelerator the tile's embedding rows stream from device memory
    either way; what the tile bounds is the fused step's (B, tile) score
    and count matrices (two f32 buffers) and the (tile, d) gradient — so
    the tile is sized to keep beta x budget for those, as a power of two
    of at least 128.
    Refresh follows the reference configs' cadence: an expected
    TILE_DRAWS_PER_SLOT draws per slot between refreshes, floored at one
    batch (the on-device sampler refreshes at most once per batch).

    Returns values for cfg.tile_size <= 0 ("auto"); explicit settings are
    never overridden.
    """
    import math

    per_elem = 2 * 4  # S and counts, f32
    t = TILE_TUNE_BETA * budget_bytes / (per_elem * max(1, cfg.batch_size))
    t = 1 << max(7, round(math.log2(max(2.0, t))))  # nearest power of two
    if cfg.num_items:
        t = min(t, max(128, 1 << int(math.log2(max(128, cfg.num_items)))))
    refresh = max(cfg.batch_size, t * TILE_DRAWS_PER_SLOT)
    return t, refresh


def init_sampler_state(cfg: CFConfig, key: jax.Array) -> SamplerState:
    if cfg.neg_sampler == NEG_SAMPLER_TILE:
        tile = jax.random.randint(
            key, (cfg.tile_size,), 0, cfg.num_items, dtype=jnp.int32
        )
    else:
        tile = jnp.zeros((1,), jnp.int32)
    return SamplerState(tile=tile, iterations=jnp.asarray(0, jnp.int32))


def _uniform_negatives(
    key: jax.Array,
    batch: int,
    num_negs: int,
    num_items: int,
    pos_ids: jnp.ndarray,
    ignore_pos: bool,
) -> jnp.ndarray:
    k1, k2 = jax.random.split(key)
    negs = jax.random.randint(
        k1, (batch, num_negs), 0, num_items, dtype=jnp.int32
    )
    if ignore_pos:
        # Redraw slots that hit the positive; a double collision has
        # probability (1/num_items)^2 and is accepted (the reference's
        # keep-stale-value behavior is equally approximate).
        alt = jax.random.randint(
            k2, (batch, num_negs), 0, num_items, dtype=jnp.int32
        )
        negs = jnp.where(negs == pos_ids[:, None], alt, negs)
    return negs


def _tile_negatives(
    key: jax.Array,
    state: SamplerState,
    batch: int,
    num_negs: int,
    num_items: int,
    tile_size: int,
    refresh_interval: int,
    real=None,
) -> tuple[jnp.ndarray, SamplerState]:
    """Tile sampler for one batch of ``batch`` samples.

    The reference refreshes when iterations % refresh_interval == 0, once
    per sample (random_tile_negative_sampler.cpp:33-45). A batch advances
    the counter by its REAL (weight > 0) sample count — the reference has
    no padding samples, so only real rows count toward the refresh cadence
    (``real``; defaults to the full batch width) — and the tile is
    refreshed when those samples cross a refresh boundary (at most one
    refresh per batch — exact when batch <= refresh_interval, which
    configs satisfy: refresh 8192 >= batch). An all-padding batch (the
    fused sub-epoch program pads ragged buckets with whole weight-0
    batches) is a sampler no-op: counter unchanged, no refresh — which is
    what makes the fused program's tile cadence identical to the
    per-bucket dispatch path's.
    """
    k_refresh, k_draw = jax.random.split(key)
    it = state.iterations
    adv = (
        jnp.asarray(batch, jnp.int32)
        if real is None
        else real.astype(jnp.int32)
    )
    # Refresh iff some sample j in [it, it+adv) satisfies
    # j % refresh_interval == 0 (the reference's per-sample condition).
    phase = it % refresh_interval
    needs_refresh = (adv > 0) & jnp.logical_or(
        phase == 0, phase + adv > refresh_interval
    )
    fresh = jax.random.randint(
        k_refresh, (tile_size,), 0, num_items, dtype=jnp.int32
    )
    tile = jnp.where(needs_refresh, fresh, state.tile)
    idx = jax.random.randint(
        k_draw, (batch, num_negs), 0, tile_size, dtype=jnp.int32
    )
    new_state = SamplerState(tile=tile, iterations=it + adv)
    return NegSample(ids=tile[idx], tile=tile, tile_idx=idx), new_state


def sample_negatives(
    key: jax.Array,
    state: SamplerState,
    pos_ids: jnp.ndarray,
    cfg: CFConfig,
    real=None,
) -> tuple[NegSample, SamplerState]:
    """Draw (B, num_negs) negatives for one batch.

    Tile mode follows the reference tile sampler's ``sampling()`` (no
    positive-avoidance — random_tile_negative_sampler.cpp:31-45); uniform
    mode follows ``ignore_pos_sampling`` when cfg.ignore_pos.
    ``real``: optional traced count of REAL (weight > 0) samples in the
    batch — the iteration-counter advance and tile-refresh cadence count
    only real samples (see ``_tile_negatives``).
    """
    batch = pos_ids.shape[0]
    if cfg.neg_sampler == NEG_SAMPLER_TILE:
        return _tile_negatives(
            key,
            state,
            batch,
            cfg.num_negs,
            cfg.num_items,
            cfg.tile_size,
            cfg.refresh_interval,
            real=real,
        )
    negs = _uniform_negatives(
        key, batch, cfg.num_negs, cfg.num_items, pos_ids, cfg.ignore_pos
    )
    adv = (
        jnp.asarray(batch, jnp.int32)
        if real is None
        else real.astype(jnp.int32)
    )
    return (
        NegSample(ids=negs, tile=None, tile_idx=None),
        state.replace(iterations=state.iterations + adv),
    )
