"""Fitted-model layer: the PCA variants."""

from .pca import SparsePCA, SparsePCABuilder, make_engine_operator  # noqa: F401
from .masked_pca import MaskedSparsePCA, MaskedSparsePCABuilder  # noqa: F401
