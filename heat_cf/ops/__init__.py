from heat_cf.ops.similarity import pair_scores
from heat_cf.ops.losses import sample_losses

__all__ = ["pair_scores", "sample_losses"]
