"""SVD engines over the operator seam."""

from .operators import (  # noqa: F401
    CenteredOperator,
    DenseOperator,
    DensifiedOperator,
    MaskedOperator,
    SparseOperator,
    TiledSparseOperator,
    bf16_terms,
)
from .svd import SvdResult, cholesky_qr2, randomized_svd, svd_flip  # noqa: F401
from .lanczos import (  # noqa: F401
    default_lanczos_steps,
    lanczos_svd,
    max_lanczos_steps,
)
from .block_lanczos import block_lanczos_svd  # noqa: F401
from .gram import (  # noqa: F401
    GramPCAEngine,
    gram_matrix,
    gram_pca_graph,
    solve_gram_topk,
    topk_psd_eigh,
)
