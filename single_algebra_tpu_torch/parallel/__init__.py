"""Device-mesh parallelism of one process: row-sharded operators, sharded
PCA and sharded Gram PCA (``parallel/pipeline.py`` of the JAX package is
not ported yet)."""

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
