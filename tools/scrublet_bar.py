"""The JAX package's scrublet on the smoke's planted-doublet recipe, on the CPU.

``chip_smoke.py``'s ``analysis`` phase runs the port's ``scrublet`` on one
10x lane (20,000 of cell 1's cells, 6 % planted doublets across clusters)
and holds its AUROC to a bar taken from this script: the same recipe
(``chip_smoke.planted_doublets`` over ``cluster_counts_big(..., 30000,
n_clusters=64, seed=7, density=0.01)``) at 5,000 rows through the JAX
package on the host. Run from the repository root:

    python tools/scrublet_bar.py [rows]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(rows: int = 5_000) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from benchmarks._datagen import cluster_counts_big
    from chip_smoke import SCRUBLET_RATE, auroc, planted_doublets
    from single_algebra_tpu import SparseMatrix
    from single_algebra_tpu.doublets import scrublet

    X = cluster_counts_big(4 * rows, 30_000, n_clusters=64, seed=7, density=0.01).tocsr()
    Xp, is_doublet = planted_doublets(X, rows, SCRUBLET_RATE, seed=21)
    t0 = time.perf_counter()
    res = scrublet(SparseMatrix.from_scipy(Xp))
    print(json.dumps(dict(rows=rows, planted=int(is_doublet.sum()),
                          auroc=auroc(res.doublet_scores, is_doublet),
                          predicted=int(res.predicted.sum()),
                          predicted_planted=int((res.predicted & is_doublet).sum()),
                          threshold=res.threshold, seconds=time.perf_counter() - t0,
                          backend=jax.default_backend())))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
