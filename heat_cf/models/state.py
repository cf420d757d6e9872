"""Training state: embedding tables + aggregator weights as a JAX pytree.

The reference splits this across torch-initialized numpy buffers aliased by
C++ (models.py:13-16, 26-32; embedding.cpp:10-45) plus per-table gradient
arrays zeroed each sub-epoch (embedding.cpp:41-45). Here the whole mutable
training state is one immutable pytree threaded through a jitted/donated
train step; the "gradient tables" exist only in the reference-parity
``sgd_mode="accum"`` configuration.

Initialization parity: user/item embeddings ~ N(0, 1e-2) (models.py:15-16),
aggregator weights0 ~ N(0, 1e-2) (behavior_aggregators.py:15-16).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from heat_cf.config import CFConfig, SGD_MODE_ACCUM

INIT_STD = 1e-2  # reference nn.init.normal_(w, std=1e-2)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    """All mutable training state.

    Attributes:
      user_emb: (U, d) user embedding table.
      item_emb: (I, d) item embedding table.
      w0: (d, d) behavior-aggregator weights.
      user_gacc / item_gacc: persistent per-row gradient accumulators,
        present only in sgd_mode="accum" (reference grad tables,
        embedding.cpp:14-16); None otherwise.
      lr: current learning rate (scheduled on host per epoch,
        engine.cpp:156-160).
      step: global batch counter.
      attn_q: (d,) learned attention query, present only when
        cfg.aggregator == "self_attention" (the reference's named-but-
        unimplemented attention aggregation, behavior_aggregators.cpp:27);
        None otherwise.
      opt_slots: optimizer moment tables, present only for
        cfg.optimizer in ("adagrad", "adam"); a dict keyed
        "{user,item,w0,attn_q}_{m,v}" ("_m" for Adam only), each shaped
        like its parameter. None for SGD (the reference's only optimizer,
        engine.cpp:16).
    """

    user_emb: jax.Array
    item_emb: jax.Array
    w0: jax.Array
    user_gacc: Optional[jax.Array]
    item_gacc: Optional[jax.Array]
    lr: jax.Array
    step: jax.Array
    attn_q: Optional[jax.Array] = None
    opt_slots: Optional[dict] = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def init_train_state(cfg: CFConfig, key: jax.Array) -> TrainState:
    """Initialize embeddings and aggregator weights (parity with reference).

    cfg.emb_pad > emb_dim allocates every d-wide array at the padded
    physical width with ZERO tail columns (and zero pad rows/cols for w0)
    — much faster to row-scatter at huge tables, at the price of the
    extra at-rest bytes (see CFConfig.emb_pad). The zero tails are invariant
    under training (zero reads -> zero grads/moments -> zero writes), so
    the padded model computes bit-identical math to the unpadded one.
    """
    ku, ki, kw, kq = jax.random.split(key, 4)
    dtype = jnp.dtype(cfg.param_dtype)
    d = cfg.emb_dim
    width = cfg.emb_pad if cfg.emb_pad else d

    def pad_cols(x):
        # Cast BEFORE padding: an f32 width-128 concat at 16M rows
        # materializes three multi-GB temps eagerly (measured OOM); the
        # param-dtype concat peaks at half that and the real block is
        # identical either way.
        if width == d:
            return x
        return jnp.concatenate(
            [x, jnp.zeros((x.shape[0], width - d), x.dtype)], axis=1
        )

    user_emb = pad_cols(
        (
            jax.random.normal(ku, (cfg.num_users, d), jnp.float32)
            * INIT_STD
        ).astype(dtype)
    )
    item_emb = pad_cols(
        (
            jax.random.normal(ki, (cfg.num_items, d), jnp.float32)
            * INIT_STD
        ).astype(dtype)
    )
    w0 = (
        jax.random.normal(kw, (d, d), jnp.float32) * INIT_STD
    ).astype(jnp.float32)
    if width != d:
        w0 = jnp.zeros((width, width), jnp.float32).at[:d, :d].set(w0)
    attn_q = None
    if cfg.aggregator == "self_attention":
        attn_q = (
            jax.random.normal(kq, (cfg.emb_dim,), jnp.float32) * INIT_STD
        )
        if width != d:
            # Zero tail, like w0: history rows carry zero tails, so the
            # logits and attn_q's gradient tail are exactly zero, and
            # the pad stays zero through every optimizer step.
            attn_q = jnp.zeros((width,), jnp.float32).at[:d].set(attn_q)
    opt_slots = None
    if cfg.optimizer in ("adagrad", "adam"):
        params = {"user": user_emb, "item": item_emb, "w0": w0}
        if attn_q is not None:
            params["attn_q"] = attn_q
        opt_slots = {
            f"{name}_v": jnp.zeros(p.shape, jnp.float32)
            for name, p in params.items()
        }
        if cfg.optimizer == "adam":
            opt_slots.update(
                {
                    f"{name}_m": jnp.zeros(p.shape, jnp.float32)
                    for name, p in params.items()
                }
            )
    accum = cfg.sgd_mode == SGD_MODE_ACCUM
    return TrainState(
        user_emb=user_emb,
        item_emb=item_emb,
        w0=w0,
        user_gacc=jnp.zeros_like(user_emb) if accum else None,
        item_gacc=jnp.zeros_like(item_emb) if accum else None,
        lr=jnp.asarray(cfg.l_r, jnp.float32),
        step=jnp.asarray(0, jnp.int32),
        attn_q=attn_q,
        opt_slots=opt_slots,
    )


def zero_grad_accumulators(state: TrainState) -> TrainState:
    """Reference zero_grad at sub-epoch boundaries (engine.cpp:344-347)."""
    return state.replace(
        user_gacc=(
            jnp.zeros_like(state.user_gacc)
            if state.user_gacc is not None
            else None
        ),
        item_gacc=(
            jnp.zeros_like(state.item_gacc)
            if state.item_gacc is not None
            else None
        ),
    )
