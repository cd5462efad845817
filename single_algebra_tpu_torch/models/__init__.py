"""Fitted-model layer: the PCA variants, streaming PCA, t-SNE, UMAP, KMeans,
spectral clustering, diffusion maps, MNN correction and LSI."""

from .pca import SparsePCA, SparsePCABuilder, make_engine_operator  # noqa: F401
from .masked_pca import MaskedSparsePCA, MaskedSparsePCABuilder  # noqa: F401
from .streaming_pca import StreamingSparsePCA  # noqa: F401
from .umap import UMAP, UMAPConfig  # noqa: F401
from .kmeans import KMeans, KMeansBuilder  # noqa: F401
from .spectral import SpectralClustering, SpectralClusteringBuilder  # noqa: F401
from .diffmap import diffmap, diffusion_pseudotime, DiffMapResult  # noqa: F401
from .harmony import harmony, HarmonyResult  # noqa: F401
from .mnn import mnn_correct, MNNResult  # noqa: F401
from .draw_graph import draw_graph  # noqa: F401
from .lsi import lsi, LSIResult  # noqa: F401
from .nmf import NMF  # noqa: F401
from . import tsne  # noqa: F401
