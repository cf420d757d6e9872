from heat_cf.evaluation.metrics import evaluate_metrics, parse_metric
from heat_cf.evaluation.evaluator import topk_scores, full_sim_matrix

__all__ = ["evaluate_metrics", "parse_metric", "topk_scores", "full_sim_matrix"]
