"""Jittable functional kernels (the device compute path)."""
from . import convert, sample, segment, spmm, spspmm
from .convert import ind2ptr, ptr2ind
from .segment import gather_csr, scatter_reduce, segment_csr
from .spmm import spmm_coo, spmm_csr
from .spspmm import spspmm_eager

__all__ = [
    "convert", "sample", "segment", "spmm", "spspmm",
    "ind2ptr", "ptr2ind", "gather_csr", "scatter_reduce", "segment_csr",
    "spmm_coo", "spmm_csr", "spspmm_eager",
]
