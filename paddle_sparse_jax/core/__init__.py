"""Static-shape jit core types."""
from .matrix import PaddedCOO
from .spgemm import (SpGEMMResult, matmul_padded, spspmm_padded,
                     spspmm_rowsorted)

__all__ = ["PaddedCOO", "SpGEMMResult", "matmul_padded",
           "spspmm_padded", "spspmm_rowsorted"]
