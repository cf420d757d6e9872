from heat_cf.train.engine import Engine

__all__ = ["Engine"]
