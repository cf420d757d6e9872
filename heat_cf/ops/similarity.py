"""Similarity scoring: batched cosine / dot between user, positive, negatives.

The reference computes these per sample with Eigen row ops
(matrix_factorization.cpp:43-95): dots u.u, p.p, u.p, then batched u.N^T and
per-neg norms, with an epsilon floor of 1e-8 on the squared norms
(matrix_factorization.cpp:54-56, 92-93). Here the same math is batched over
a minibatch so XLA maps the contractions onto matmuls; gradients come from
autodiff of this forward (equivalent to the reference's hand-derived cosine
gradients at matrix_factorization.cpp:62-63, 136-139, which reuse the
forward dot products — XLA's fusion achieves the same reuse).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

EPS = 1e-8  # matches the reference's machine-epsilon floor (matrix_factorization.cpp:54)


def _safe_rnorm(sq: jnp.ndarray) -> jnp.ndarray:
    """1/sqrt(max(sq, EPS)) — the reference's clamped norm reciprocal."""
    return jax.lax.rsqrt(jnp.maximum(sq, EPS))


def pair_scores(
    u: jnp.ndarray,
    p: jnp.ndarray,
    n: jnp.ndarray,
    *,
    similarity: str = "cosine",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Score (user, positive) and (user, negatives) pairs.

    Args:
      u: (B, d) aggregated user embeddings.
      p: (B, d) positive item embeddings.
      n: (B, K, d) negative item embeddings.
      similarity: "cosine" (reference behavior) or "dot".

    Returns:
      (s_up, s_un): (B,) and (B, K) similarity scores.
    """
    # f32 inputs score at true f32 (at default precision the GPU runs an
    # f32 matmul in TF32, a 10-bit mantissa — no loss for bf16-valued
    # inputs, but an un-asked-for fidelity loss for
    # compute_dtype=float32). FLOP cost is negligible at these shapes.
    prec = (
        jax.lax.Precision.HIGHEST
        if u.dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )
    compute_dtype = jnp.promote_types(u.dtype, jnp.float32)
    u = u.astype(compute_dtype)
    p = p.astype(compute_dtype)
    n = n.astype(compute_dtype)

    ein = functools.partial(
        jnp.einsum, preferred_element_type=compute_dtype, precision=prec
    )
    up = ein("bd,bd->b", u, p)
    un = ein("bd,bkd->bk", u, n)
    if similarity == "dot":
        return up, un
    uu = ein("bd,bd->b", u, u)
    pp = ein("bd,bd->b", p, p)
    nn = ein("bkd,bkd->bk", n, n)
    r_u = _safe_rnorm(uu)
    s_up = up * r_u * _safe_rnorm(pp)
    s_un = un * r_u[:, None] * _safe_rnorm(nn)
    return s_up, s_un


def tile_scores(
    u: jnp.ndarray,
    p: jnp.ndarray,
    tile_rows: jnp.ndarray,
    *,
    similarity: str = "cosine",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Score (user, positive) pairs and users against a whole negative tile.

    The tile sampler draws all of a batch's negatives from one small tile
    (T rows), so instead of gathering a (B, K, d) tensor of sampled rows we
    score every user against every tile row with one (B, d) x (d, T)
    matmul; the per-sample negative scores are then the (B, T) matrix read
    through the sampled multiplicities (ops/losses.py weighted variants).
    Mathematically identical to pair_scores over the gathered rows — same
    dots, same clamped norms — but with no (B, K)-indexed gathers on the
    forward or scatter on the backward (the tile gradient is the transposed
    matmul).

    Args:
      u: (B, d) aggregated user embeddings.
      p: (B, d) positive item embeddings.
      tile_rows: (T, d) the tile's item embeddings.

    Returns:
      (s_up, S): (B,) positive scores and (B, T) user x tile scores.
    """
    prec = (
        jax.lax.Precision.HIGHEST
        if u.dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )  # see pair_scores
    compute_dtype = jnp.promote_types(u.dtype, jnp.float32)
    u = u.astype(compute_dtype)
    p = p.astype(compute_dtype)
    t = tile_rows.astype(compute_dtype)

    ein = functools.partial(
        jnp.einsum, preferred_element_type=compute_dtype, precision=prec
    )
    up = ein("bd,bd->b", u, p)
    S = ein("bd,td->bt", u, t)
    if similarity == "dot":
        return up, S
    r_u = _safe_rnorm(ein("bd,bd->b", u, u))
    r_t = _safe_rnorm(ein("td,td->t", t, t))
    s_up = up * r_u * _safe_rnorm(ein("bd,bd->b", p, p))
    return s_up, S * r_u[:, None] * r_t[None, :]
