"""paddle_sparse_jax — a sparse linear-algebra framework for JAX.

A from-scratch JAX/XLA/Pallas re-design with the full capability surface of
``PFCCLab/paddle_sparse`` (reference layer map in SURVEY.md §1) plus the
north-star ops the reference lacks (SpMM, SpGEMM, random walks, graph
partitioning, diag family).

Layering (mirrors SURVEY.md §1, built for compiled static shapes):

* ``ops/``      — jittable functional kernels (convert/segment/spmm/spspmm/
                  sample) with ``custom_vjp`` gradients on values.
* ``core/``     — static-shape padded pytree (``PaddedCOO``) for jit /
                  shard_map compute at scale.
* facade        — ``SparseTensor`` / ``SparseStorage`` eager host API with
                  reference-compatible semantics; op modules bind their
                  methods at import time, one module per op family.
* ``parallel/`` — mesh-sharded SpMM/SpGEMM via ``shard_map`` collectives.
* ``models/``   — reference GNN models (GCN, ...) built on this library.
"""
__version__ = "0.1.0"

from .storage import SparseStorage  # noqa: E402
from .tensor import SparseTensor  # noqa: E402

# Import op modules for their side effect of binding SparseTensor methods.
from .narrow import narrow, __narrow_diag__  # noqa: E402
from .select import select  # noqa: E402
from .index_select import index_select, index_select_nnz  # noqa: E402
from .masked_select import masked_select, masked_select_nnz  # noqa: E402
from .permute import permute  # noqa: E402
from .add import add, add_, add_nnz, add_nnz_  # noqa: E402
from .mul import mul, mul_, mul_nnz, mul_nnz_  # noqa: E402
from .reduce import max, mean, min, reduction, sum  # noqa: E402,A004
from .cat import cat  # noqa: E402
from .transpose import t, transpose  # noqa: E402
from .coalesce import coalesce  # noqa: E402
from .eye import eye  # noqa: E402
from .convert import (from_jax_sparse, from_paddle_sparse, from_scipy,  # noqa: E402
                      to_jax_sparse, to_paddle_sparse, to_scipy)
from .diag import fill_diag, get_diag, remove_diag, set_diag  # noqa: E402
from .matmul import matmul, spmm, spspmm  # noqa: E402
from .sample import sample, sample_adj, saint_subgraph  # noqa: E402
from .rw import random_walk  # noqa: E402
from .partition import partition, reverse_cuthill_mckee  # noqa: E402
from .spadd import spadd  # noqa: E402

from .io import load_npz, save_npz  # noqa: E402
from .random import seed  # noqa: E402

from . import ops  # noqa: E402
from . import core  # noqa: E402
from . import profiling  # noqa: E402

__all__ = [
    "SparseStorage",
    "SparseTensor",
    "narrow",
    "__narrow_diag__",
    "select",
    "index_select",
    "index_select_nnz",
    "masked_select",
    "masked_select_nnz",
    "permute",
    "add",
    "add_",
    "add_nnz",
    "add_nnz_",
    "mul",
    "mul_",
    "mul_nnz",
    "mul_nnz_",
    "reduction",
    "sum",
    "mean",
    "min",
    "max",
    "cat",
    "t",
    "transpose",
    "coalesce",
    "eye",
    "from_scipy",
    "to_scipy",
    "from_jax_sparse",
    "to_jax_sparse",
    "from_paddle_sparse",
    "to_paddle_sparse",
    "remove_diag",
    "set_diag",
    "fill_diag",
    "get_diag",
    "matmul",
    "spmm",
    "spspmm",
    "spadd",
    "sample",
    "sample_adj",
    "saint_subgraph",
    "random_walk",
    "partition",
    "reverse_cuthill_mckee",
    "__version__",
]
