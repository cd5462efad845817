"""Fitted-model layer: the PCA variants, streaming PCA and t-SNE."""

from .pca import SparsePCA, SparsePCABuilder, make_engine_operator  # noqa: F401
from .masked_pca import MaskedSparsePCA, MaskedSparsePCABuilder  # noqa: F401
from .streaming_pca import StreamingSparsePCA  # noqa: F401
from . import tsne  # noqa: F401
