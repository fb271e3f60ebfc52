from .binning import BinMapper, BinType, MissingType
from .dataset import BinnedDataset
from .metadata import Metadata

__all__ = ["BinMapper", "BinType", "MissingType", "BinnedDataset", "Metadata"]
