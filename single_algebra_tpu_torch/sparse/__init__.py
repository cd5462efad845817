"""Sparse container and host-side payload construction."""

from .matrix import SparseMatrix, csc_matrix, csr_matrix, random_sparse  # noqa: F401
from . import convert  # noqa: F401
