"""Kernels (hand-written for Hopper) with their plain PyTorch versions.

Re-exports what the JAX package's ``ops`` does: the statistics module and
the padded-ELL products. The kernel modules (``cuda_lib``, ``densify``,
``spmm_kernel``) are imported by name where they are used; importing this
package builds and loads nothing.
"""

from . import stats  # noqa: F401
from .spmm import ell_spmm, ell_spmm_xla  # noqa: F401
