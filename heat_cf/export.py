"""Export trained model parameters for downstream systems.

The reference has no export path at all — its trained weights live in torch
tensors aliased by C++ and die with the process (SURVEY.md §5
"Checkpoint/resume"). Orbax checkpoints (heat_cf.checkpoint) are the
resume format; this module provides the *interchange* format: one portable
``.npz`` with plain numpy arrays, loadable anywhere without JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def export_embeddings(state, path: str, cfg=None) -> dict:
    """Write user/item tables (+ w0, attn_q) to a compressed ``.npz``.

    Sharded/multi-host arrays are gathered to host first. bf16 tables are
    widened to f32 (npz has no bfloat16). Returns the manifest dict that
    was written (arrays by name).

    Args:
      state: a TrainState (live ``engine.state`` or a checkpoint restore).
      path: output ``.npz`` path.
      cfg: optional CFConfig; records gamma/similarity so a consumer can
        reproduce scoring (``score = cos(gamma*u + (1-gamma)*pool@w0, i)``).
    """
    import jax

    def host(x):
        if getattr(x, "is_fully_addressable", True) is False:
            # Multi-host sharded table: gather the global array.
            from jax.experimental import multihost_utils

            x = multihost_utils.process_allgather(x, tiled=True)
        return np.asarray(jax.device_get(x)).astype(np.float32)

    out = {
        "user_emb": host(state.user_emb),
        "item_emb": host(state.item_emb),
        "w0": host(state.w0),
    }
    if cfg is not None and cfg.emb_pad and cfg.emb_pad > cfg.emb_dim:
        # Physical row padding (CFConfig.emb_pad) is a device-layout
        # detail; the interchange format carries the logical model.
        d = cfg.emb_dim
        out["user_emb"] = out["user_emb"][:, :d]
        out["item_emb"] = out["item_emb"][:, :d]
        out["w0"] = out["w0"][:d, :d]
    if state.attn_q is not None:
        out["attn_q"] = host(state.attn_q)
    if cfg is not None:
        out["meta_gamma"] = np.asarray(cfg.gamma, np.float32)
        out["meta_similarity"] = np.asarray(
            0 if cfg.similarity == "cosine" else 1, np.int32
        )
    np.savez_compressed(path, **out)
    return out


def load_embeddings(path: str) -> dict:
    """Load an :func:`export_embeddings` file back into plain numpy."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
