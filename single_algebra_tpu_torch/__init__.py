"""single_algebra_tpu_torch: the PyTorch + CUDA port of single_algebra_tpu.

A second package beside the JAX one, which stays the reference. It mirrors
the JAX package's module names (``types``, ``native``, ``sparse``,
``ops``, ``linalg``, ``models``) and imports no JAX. Its kernels are
written by hand for NVIDIA Hopper (``csrc/``), built with ``nvcc`` on
first use; on CPU tensors each kernel's wrapper runs its plain PyTorch
version.

Ported so far: ``SparseMatrix.from_scipy`` -> ``make_engine_operator``
-> ``SparsePCA`` on three engines. The densified engine
(``DensifiedOperator``: dense bf16 hi/lo payload, cuBLAS products;
``auto``'s first choice when the dense form fits), the Gram engine
(``GramPCAEngine``: densify kernel, Gram contraction, p-space solve,
projection) and the tiled engine (``TiledSparseOperator``:
``tiled_ell_spmm_t`` / ``tiled_ell_rmv_t`` kernels), with the randomized,
Lanczos (``SparsePCABuilder``'s default) and block-Lanczos solvers.
"""

from .types import (  # noqa: F401
    Direction,
    PowerIterationNormalizer,
    SVDMethod,
    set_precision_policy,
)

set_precision_policy()

from .sparse import SparseMatrix  # noqa: E402,F401
from .models import SparsePCA, SparsePCABuilder, make_engine_operator  # noqa: E402,F401

__version__ = "0.1.0"
