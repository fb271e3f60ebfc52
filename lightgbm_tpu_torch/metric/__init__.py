from .metric import Metric, create_metrics

__all__ = ["Metric", "create_metrics"]
