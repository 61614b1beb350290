from .build import build_index
from .index import GenomeIndex

__all__ = ["build_index", "GenomeIndex"]
