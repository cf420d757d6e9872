"""Contrastive ranking losses over (positive, negatives) similarity scores.

The live reference loss (matrix_factorization.cpp:96-109) is a softmax-style
pairwise-logistic loss: per sample, with scores
``s_k = (sim(u, n_k) - sim(u, p)) * (1/temperature)``,

    loss = max_score + log( exp(-max_score) + sum_k exp(s_k - max_score) )
         = logsumexp over {0} ∪ {s_k}

i.e. a numerically-stable log(1 + sum_k exp(s_k)). Its gradient w.r.t. s_k is
softmax(s_k) against the implicit 0 logit — exactly the reference's
``loss_grad = exp_score / exp_score_sum * score_mul``
(matrix_factorization.cpp:109), which autodiff reproduces.

Also provided:
* CosineContrastiveLoss — the SimpleX (CIKM'21) CCL the reference's model
  family is named after (MF_CCL): (1 - s_up) + (w/K) * sum_k relu(s_un - m).
* SigmoidPairwiseLoss — independent per-negative logistic (BPR-style)
  softplus(s_k); a working stand-in for the reference's dead commented-out
  sigmoid variant (matrix_factorization.cpp:115-116, sigmoid.cpp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from heat_cf.config import CFConfig


def pairwise_logistic_loss(
    s_up: jnp.ndarray, s_un: jnp.ndarray, score_mul: float
) -> jnp.ndarray:
    """log(1 + sum_k exp((s_un_k - s_up) * score_mul)), stable. Returns (B,)."""
    scores = (s_un - s_up[:, None]) * score_mul  # (B, K)
    # logsumexp over {0} ∪ scores, matching matrix_factorization.cpp:104-108.
    return jnp.logaddexp(0.0, jax.nn.logsumexp(scores, axis=-1))


def cosine_contrastive_loss(
    s_up: jnp.ndarray,
    s_un: jnp.ndarray,
    margin: float,
    neg_weight: float,
) -> jnp.ndarray:
    """SimpleX CCL: (1 - s_up) + (w/K) * sum_k relu(s_un_k - margin)."""
    num_negs = s_un.shape[-1]
    neg_term = jnp.sum(jax.nn.relu(s_un - margin), axis=-1) * (
        neg_weight / num_negs
    )
    return (1.0 - s_up) + neg_term


def sigmoid_pairwise_loss(
    s_up: jnp.ndarray, s_un: jnp.ndarray, score_mul: float
) -> jnp.ndarray:
    """Mean per-negative softplus((s_un_k - s_up) * score_mul)."""
    scores = (s_un - s_up[:, None]) * score_mul
    return jnp.mean(jax.nn.softplus(scores), axis=-1)


def sample_losses(
    s_up: jnp.ndarray, s_un: jnp.ndarray, cfg: CFConfig
) -> jnp.ndarray:
    """Dispatch on cfg.loss. Returns per-sample losses (B,)."""
    if cfg.loss == "PairwiseLogisticLoss":
        return pairwise_logistic_loss(s_up, s_un, cfg.score_mul)
    if cfg.loss == "CosineContrastiveLoss":
        return cosine_contrastive_loss(
            s_up, s_un, cfg.ccl_margin, cfg.ccl_neg_weight
        )
    if cfg.loss == "SigmoidPairwiseLoss":
        return sigmoid_pairwise_loss(s_up, s_un, cfg.score_mul)
    raise ValueError(f"unknown loss {cfg.loss!r}")


def sample_losses_weighted(
    s_up: jnp.ndarray,
    S: jnp.ndarray,
    counts: jnp.ndarray,
    num_negs: int,
    cfg: CFConfig,
) -> jnp.ndarray:
    """Losses over tile scores with sampled multiplicities.

    Every supported loss depends on the negatives only through a sum of
    elementwise terms, so a batch row's K sampled negative scores — a
    multiset of tile scores — can be evaluated as the full (B, T) tile
    score matrix weighted by ``counts[b, t]`` (how many of row b's K draws
    hit tile slot t; sum_t counts[b, t] == K). Exactly the same multiset as
    gathering the sampled scores, with no per-draw gather/scatter.

    Args:
      s_up: (B,) positive scores.
      S: (B, T) user x tile scores (ops/similarity.py tile_scores).
      counts: (B, T) draw multiplicities, float.
      num_negs: K (the reference divides per-negative means by K, not by T).
    """
    if cfg.loss == "PairwiseLogisticLoss":
        sc = (S - s_up[:, None]) * cfg.score_mul
        # logsumexp over {0} ∪ the sampled multiset, weighted by counts
        # (matrix_factorization.cpp:101-109's max-subtraction, batched).
        m = jnp.max(jnp.where(counts > 0, sc, -jnp.inf), axis=1)
        m = jnp.maximum(m, 0.0)
        sumexp = jnp.sum(counts * jnp.exp(sc - m[:, None]), axis=1)
        return m + jnp.log(jnp.exp(-m) + sumexp)
    if cfg.loss == "CosineContrastiveLoss":
        neg = jnp.sum(counts * jax.nn.relu(S - cfg.ccl_margin), axis=1)
        return (1.0 - s_up) + neg * (cfg.ccl_neg_weight / num_negs)
    if cfg.loss == "SigmoidPairwiseLoss":
        sc = (S - s_up[:, None]) * cfg.score_mul
        return jnp.sum(counts * jax.nn.softplus(sc), axis=1) / num_negs
    raise ValueError(f"unknown loss {cfg.loss!r}")
