"""Numpy oracle: sequential per-sample forward/backward with the reference's
exact semantics, written from the survey of matrix_factorization.cpp:15-181,
behavior_aggregators.cpp:51-153, sgd.cpp:14-26, optimizer.cpp:17-22.

This is the parity anchor: the batched device train step must reproduce these
numbers (up to f32 summation order) on batches with disjoint ids.

Semantics captured:
* aggregation happens before all dot products; the aggregated user embedding
  is the "u" of every cosine and is written back to the user table;
* cosine norms are floored at sqrt(1e-8);
* loss = logsumexp over {0} ∪ {(cos_un - cos_up)/0.07};
* gradient rows live in persistent tables, accumulate across calls, are
  clipped in place by sparse_step, and the user row is rescaled by gamma on
  every aggregator backward;
* weights0 accumulates outer(means, (1-gamma)*user_grad_row) and applies
  -lr * acc/32 every 32 samples.
"""

from __future__ import annotations

import dataclasses

import numpy as np

EPS = 1e-8


@dataclasses.dataclass
class OracleModel:
    user_emb: np.ndarray   # (U, d) f32, mutated in place
    item_emb: np.ndarray   # (I, d)
    w0: np.ndarray         # (d, d)
    user_gacc: np.ndarray  # (U, d) persistent grad rows
    item_gacc: np.ndarray  # (I, d)
    w0_acc: np.ndarray     # (d, d) aggregator minibatch accumulator
    iteration: int = 0

    @classmethod
    def create(cls, user_emb, item_emb, w0):
        return cls(
            user_emb=np.array(user_emb, np.float32),
            item_emb=np.array(item_emb, np.float32),
            w0=np.array(w0, np.float32),
            user_gacc=np.zeros_like(np.asarray(user_emb, np.float32)),
            item_gacc=np.zeros_like(np.asarray(item_emb, np.float32)),
            w0_acc=np.zeros((w0.shape[0], w0.shape[0]), np.float32),
        )


def forward_backward(
    m: OracleModel,
    user: int,
    pos: int,
    negs: list[int],
    his_items: np.ndarray,
    his_masks: np.ndarray,
    *,
    lr: float,
    clip_val: float,
    gamma: float = 0.4,
    score_mul: float = 1.0 / 0.07,
    aggr_minibatch: int = 32,
) -> float:
    """One training sample; mutates the model; returns the sample loss."""
    d = m.user_emb.shape[1]
    u = m.user_emb[user].copy()

    # --- behavior aggregation (forward) ---
    num_his = int(his_masks[user])
    if num_his > 0:
        means = m.item_emb[his_items[user, :num_his]].mean(axis=0)
    else:
        means = np.zeros(d, np.float32)
    f_c0 = means @ m.w0
    u = gamma * u + (1.0 - gamma) * f_c0  # aggregated user embedding

    p = m.item_emb[pos].copy()
    n = m.item_emb[list(negs)].copy()  # (K, d), buffered pre-update

    # --- dots / cosines with the eps floor ---
    uu = float(u @ u)
    pp = float(p @ p)
    up = float(u @ p)
    un_ = n @ u              # (K,)
    nn = (n * n).sum(axis=1)  # (K,)

    u_norm = np.sqrt(max(uu, EPS))
    p_norm = np.sqrt(max(pp, EPS))
    n_norm = np.sqrt(np.maximum(nn, EPS))
    cos_up = up / (u_norm * p_norm)
    cos_un = un_ / (u_norm * n_norm)

    scores = (cos_un - cos_up) * score_mul
    mx = scores.max()
    exp_sum = np.exp(scores - mx).sum() + np.exp(-mx)
    loss = mx + np.log(exp_sum)
    lg = np.exp(scores - mx) / exp_sum * score_mul  # (K,)

    # --- analytic cosine gradients (reusing forward dots) ---
    u_norm3 = u_norm**3
    p_norm3 = p_norm**3
    n_norm3 = n_norm**3
    d_cosup_du = (uu * p - up * u) / (u_norm3 * p_norm)
    neg_d_cosup_dp = -(pp * u - up * p) / (u_norm * p_norm3)

    g_u = np.zeros(d, np.float32)
    g_p = np.zeros(d, np.float32)
    for k in range(len(negs)):
        d_cosun_du = (uu * n[k] - un_[k] * u) / (u_norm3 * n_norm[k])
        d_cosun_dn = (nn[k] * u - un_[k] * n[k]) / (u_norm * n_norm3[k])
        g_u += lg[k] * (d_cosun_du - d_cosup_du)
        g_p += lg[k] * neg_d_cosup_dp
        # negative row: accumulate into grad table, clip, update, store
        acc = m.item_gacc[negs[k]] + lg[k] * d_cosun_dn
        acc = np.clip(acc, -clip_val, clip_val)
        m.item_emb[negs[k]] = n[k] - lr * acc
        m.item_gacc[negs[k]] = acc

    # --- aggregator backward: w0 minibatch update + gamma rescale ---
    user_row = m.user_gacc[user] + g_u
    f_c0_grad = (1.0 - gamma) * user_row
    m.w0_acc += np.outer(means, f_c0_grad)
    m.iteration += 1
    if m.iteration % aggr_minibatch == 0:
        m.w0 -= lr * (m.w0_acc / aggr_minibatch)
        m.w0_acc[:] = 0.0
    user_row = gamma * user_row

    # --- user/pos sparse SGD (clip into the grad tables) ---
    user_row = np.clip(user_row, -clip_val, clip_val)
    m.user_emb[user] = u - lr * user_row
    m.user_gacc[user] = user_row

    pos_row = np.clip(m.item_gacc[pos] + g_p, -clip_val, clip_val)
    m.item_emb[pos] = p - lr * pos_row
    m.item_gacc[pos] = pos_row
    return float(loss)
