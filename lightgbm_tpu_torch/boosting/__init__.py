from .gbdt import GBDT

__all__ = ["GBDT"]
