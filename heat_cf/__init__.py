"""heat_cf — a collaborative-filtering training framework for NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capabilities of HEAT
(ICS'23, "Highly Efficient and Affordable Training system" for SimpleX-style
collaborative filtering): matrix factorization with a behavior-aggregation
layer, cosine/pairwise-logistic contrastive loss, configurable negative
sampling, SGD with gradient clipping and milestone LR schedules, and full
user x item top-k ranking evaluation.

Where the reference (surveyed in SURVEY.md) is a cache-tiled per-sample
CPU SGD engine driven over MPI, this framework keeps the whole training
state on the accelerator (one NVIDIA GPU, or a mesh of them):

* minibatched, vectorized gather -> fused similarity/loss/grad ->
  segment-sum scatter-update, jitted end to end;
* embedding tables row-sharded over a `jax.sharding.Mesh` (users over the
  "data" axis, items over the "model" axis) with XLA collectives in place
  of the reference's per-row MPI_Bcast/MPI_Allreduce;
* optional Orbax checkpointing, deterministic `jax.random` seeding, and
  an on-device tiled evaluator instead of a host-side numpy argpartition.
"""

from heat_cf.config import CFConfig, load_config
from heat_cf.models.state import TrainState, init_train_state

__version__ = "0.1.0"

__all__ = [
    "CFConfig",
    "load_config",
    "TrainState",
    "init_train_state",
    "__version__",
]
