"""single_algebra_tpu_torch: the PyTorch + CUDA port of single_algebra_tpu.

A second package beside the JAX one, which stays the reference. It mirrors
the JAX package's module names (``types``, ``native``, ``sparse``,
``ops``, ``linalg``, ``models``) and imports no JAX. Its kernels are
written by hand for NVIDIA Hopper (``csrc/``), built with ``nvcc`` on
first use; on CPU tensors each kernel's wrapper runs its plain PyTorch
version.

The reference crate's surface: ``SparseMatrix`` with its
device padded-ELL layouts, statistics and value maps (``normalize``,
``log1p_normalize``, ``map_stored``); ``dense`` (normalize, log1p);
``SparsePCA`` and ``MaskedSparsePCA`` on four engines through
``make_engine_operator``: the densified engine (``DensifiedOperator``:
dense bf16 hi/lo payload, cuBLAS products; ``auto``'s first choice when
the dense form fits), the Gram engine (``GramPCAEngine``: densify kernel,
Gram contraction, p-space solve, projection), the tiled engine
(``TiledSparseOperator``: ``tiled_ell_spmm_t`` / ``tiled_ell_rmv_t``
kernels) and the gather engine (``SparseOperator``), with the randomized,
Lanczos (the builders' default) and block-Lanczos solvers; the
``similarity`` measures; t-SNE (``models.tsne``, exact and knn modes),
``StreamingSparsePCA``, and the mesh layer ``parallel`` (row-sharded
engines, sharded PCA and Gram PCA over a one-process ``Mesh`` of devices,
and the ``mesh=`` branches of t-SNE and streaming PCA). The single-cell
workflow after them: ``qc`` (QC metrics, cell / gene filters),
``preprocess`` (normalize_total, TF-IDF, Pearson residuals, aggregates,
scale, regress_out, ComBat, sampling), ``feature_selection`` (HVG
selection, four flavors), ``recipes`` (the three scanpy recipes),
``neighbors`` (exact, mesh and IVF kNN, connectivities, bbknn),
``models.KMeans``, ``models.UMAP`` and ``cluster`` (Leiden, PAGA,
dendrogram). The analysis surface: ``metrics`` (silhouette, ARI / NMI,
Moran's I / Geary's C, embedding density, LISI, kBET),
``rank_genes_groups`` (t-test, wilcoxon, logreg), ``score_genes``,
``ingest``, ``magic``, ``scrublet``, ``io`` (h5ad, 10x mtx) and the
models ``SpectralClustering``, ``diffmap``, ``mnn_correct`` and ``lsi``.
The last modules: ``models.draw_graph`` (ForceAtlas2, single device and
``mesh=``), ``models.harmony``, ``models.NMF``, the mesh pipeline stages
``parallel.mesh_*`` (QC, normalize, log1p, scale, HVG, grouped moments,
t-test ``rank_genes_groups``) and ``utils.tracing`` (stage timings and
profiler ranges). With them the port does all that the JAX package does,
apart from its TPU-only parts (the compile cache, ``interpret=``).
Every public fit, transform and product runs under
:func:`precision_policy` (full float32, the caller's flags restored
after).
"""

from .types import (  # noqa: F401
    Direction,
    PowerIterationNormalizer,
    SVDMethod,
    precision_policy,
    set_precision_policy,
)
from .sparse import SparseMatrix, csc_matrix, csr_matrix, random_sparse  # noqa: F401
from .models import (  # noqa: F401
    MaskedSparsePCA,
    MaskedSparsePCABuilder,
    SparsePCA,
    SparsePCABuilder,
    StreamingSparsePCA,
    make_engine_operator,
    tsne,
)
from .feature_selection import (  # noqa: F401
    HVGResult,
    highly_variable_genes,
    highly_variable_genes_from_moments,
)
from .qc import calculate_qc_metrics  # noqa: F401
from .cluster import leiden  # noqa: F401
from .preprocess import (  # noqa: F401
    combat,
    normalize_pearson_residuals,
    regress_out,
    scale,
)
from .recipes import (  # noqa: F401
    recipe_pearson_residuals,
    recipe_seurat,
    recipe_zheng17,
)
from . import cluster, dense, neighbors, preprocess, qc, similarity  # noqa: F401
from . import io, metrics  # noqa: F401
from .de import rank_genes_groups  # noqa: F401
from .scoring import score_genes, score_genes_cell_cycle  # noqa: F401
from .ingest import ingest, transfer_values  # noqa: F401
from .doublets import scrublet  # noqa: F401
from .imputation import magic  # noqa: F401

__version__ = "0.1.0"
