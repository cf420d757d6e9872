"""Data layer: click-file parsing, user-range sharding, synthetic data.

Counterpart of the reference frontend data layer
(cf/datasets.py:14-216 and the MPI scatter in cf/main.py:47-97).
"""

from heat_cf.data.datasets import (
    ClickDataset,
    shard_by_user_range,
    user_range_bounds,
)
from heat_cf.data.synthetic import synthetic_click_dataset

__all__ = [
    "ClickDataset",
    "shard_by_user_range",
    "user_range_bounds",
    "synthetic_click_dataset",
]
