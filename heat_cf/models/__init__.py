from heat_cf.models.state import TrainState, init_train_state
from heat_cf.models.aggregator import aggregate_history

__all__ = ["TrainState", "init_train_state", "aggregate_history"]
