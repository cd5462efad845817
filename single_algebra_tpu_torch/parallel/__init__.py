"""Device-mesh parallelism of one process: row-sharded operators, sharded
PCA, sharded Gram PCA and the mesh-sharded pipeline stages (QC,
normalization, log1p, scaling, HVG selection, grouped moments and the
t-test ``rank_genes_groups``)."""

from .sharded import (  # noqa: F401
    Mesh,
    ShardedDensified,
    ShardedSpMM,
    ShardedTiled,
    make_mesh,
    mesh_budget_bytes,
)
from .pca import (  # noqa: F401
    ShardedPCAResult,
    choose_sharded_engine,
    sharded_pca_fit_transform,
)
from .gram import ShardedGram, sharded_gram_pca  # noqa: F401
from .pipeline import (  # noqa: F401
    mesh_col_moments,
    mesh_grouped_moments,
    mesh_highly_variable_genes,
    mesh_log1p,
    mesh_map_stored,
    mesh_normalize_total,
    mesh_qc_metrics,
    mesh_rank_genes_groups,
    mesh_row_stats,
    mesh_scale,
    mesh_sum_row_masked,
)
