"""Fitted-model layer: the PCA variants, streaming PCA, t-SNE, UMAP and KMeans."""

from .pca import SparsePCA, SparsePCABuilder, make_engine_operator  # noqa: F401
from .masked_pca import MaskedSparsePCA, MaskedSparsePCABuilder  # noqa: F401
from .streaming_pca import StreamingSparsePCA  # noqa: F401
from .umap import UMAP, UMAPConfig  # noqa: F401
from .kmeans import KMeans, KMeansBuilder  # noqa: F401
from . import tsne  # noqa: F401
