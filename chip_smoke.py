#!/usr/bin/env python3
"""Chip smoke of the torch port: its main paths once each, on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py    # ~17 minutes: north star, the preprocessing and masked-PCA
                             # pipeline, the single-cell workflow and the analysis surface,
                             # streaming PCA, densified path, tiled path and LSI, t-SNE,
                             # ForceAtlas2, Harmony, NMF, the mesh pipeline stages, a
                             # profiler trace, and the mesh beside them

Phases, one JSON line each:

1. ``env``: card name and power limit, torch / CUDA / nvcc versions,
   whether triton imports and CUTLASS's headers exist.
2. ``build``: every kernel library compiled from
   ``single_algebra_tpu_torch/csrc`` (one ``nvcc -Xptxas -v`` per source,
   all started together), with the time and the ptxas report per kernel.
3. ``kernel``: the densify kernel against its plain PyTorch version AND
   against the one-warp kernel (the port's first densify kernel, kept as
   a reference), which must all agree bit for bit: small cases (wt 4, 8,
   16, 32 and 40, duplicate ids, ids outside the tile, a slab at a
   non-zero offset that is not a whole number of blocks, col_tile 256 and
   128), then the Gram path's slab shapes (slab 8192, col_tile 256,
   30,720 dense rows, wt 8, 16 and 32, plus a slab with duplicate ids)
   for int8, bf16 and f32 outputs, each timed (CUDA events) beside the
   one-warp kernel, the plain version and its bound. ``main_path`` fails
   if the engine has a bucket width that was not held here.
4. ``gram_tiers``: the int8, bf16 and f32 Gram tiers (blocked path) on the
   card against a float64 host Gram.
5. ``main_path``: the north star. ``SparsePCABuilder().n_components(50)
   .svd_method(SVDMethod.random(10, 7, QR))`` ``fit_transform`` with
   engine 'auto' on a 1M x 30k planted-spectrum count matrix
   (``benchmarks/_datagen.py``), cold (the first fit on a matrix fresh
   from ``from_scipy``: every value gate, the column stats and the payload
   build are inside the window) and warm. The engine must be
   ``GramPCAEngine``, the densify kernel must have launched, the scores
   must be finite and of shape [n, 50], and the explained variance must
   agree with an independent float64 truth computed on the card (dense
   float64 Gram of CSR row chunks, float64 subspace iteration,
   ``eigvalsh`` of the projected Gram) to <= 1e-5 relative (max error
   over the 50 EVs / the largest EV).
6. ``breakdown``: the warm layers one by one (CUDA events), and ``idle``:
   the device idle share of the Gram pass and of a warm ``fit_transform``
   from one ``torch.profiler`` window each.
7. ``dense_path``: the densified engine. ``SparsePCABuilder``'s DEFAULTS,
   ``SparsePCABuilder().n_components(50).build().fit_transform(X)``
   (Lanczos, adaptive, tolerance 1e-6), with engine 'auto' on a 400,000 x
   30,000 count matrix (dense bf16 24 GB <= 0.6 x 80 GB), cold and warm;
   ``lanczos_block(8)``; the randomized method cold and warm. The engine
   must be ``DensifiedOperator``. ``dense_products``: its products timed
   at 1, 8 and 50 operand columns and held to a float64 product (precise
   class: 1e-6). ``dense_idle``: the device idle share of a warm default
   fit. ``dense_routes``: host densify + upload against upload + scatter
   on the card, identical payloads. ``dense_ev``: Lanczos never centers
   the SVD, so the two Lanczos fits are held to the float64 truth of the
   UNCENTERED Gram's top 50 (fail above 1e-5); the randomized fit, an
   A-space sketch at q = 7, to a float64 run of the same algorithm with
   the same sketch (fail above 1e-4), and its error against the centered
   truth to a loose regression bar (fail above 5e-3; 1.7e-3 measured).
   ``dense_lo``: the same counts times a float32 constant (200,000
   rows): the engine must keep a non-zero lo half, both routes must
   agree, and the default fit must meet the same bar; its Lanczos steps
   are printed beside those of the same rows with their exact counts.
8. ``kernel_spmm`` / ``kernel_rmv``: the tiled engine's kernels against
   their plain versions on the card, on random payloads of the tiled
   path's tile geometry (R 16,384, 237 tiles of 256 columns, kp 64): wt 16
   bf16 payload x bf16 and x f32 operand, wt 24 f32 x f32, duplicate ids,
   an all-padding row block; and, inside ``tiled_path``, on the engine's
   own payload at all its 500,736 rows (bf16 x bf16 and bf16 x f32 at kp
   64, whose times go into the kernels line; spmm at kp 56; both at kp 8
   with a float32 operand, the Lanczos solvers' shape). Each case fails
   above max |kernel - plain| / max |plain| = 1e-5 or where a repeated
   launch differs.
9. ``tiled_path``: the randomized fit with engine 'auto' on a 500,000
   x 60,664 count matrix (all human genes; the dense bf16 form does not
   fit 0.6 x 80 GB and the Gram does not fit p > 40,960), cold and warm.
   The engine must be ``TiledSparseOperator``, both tiled kernels must
   have launched, the scores must be finite and [500000, 50].
   ``tiled_ev``: the explained variance against a float64 run of the same
   randomized algorithm with the same sketch (``randomized_svd`` over
   float64 ``torch.sparse_csr_tensor`` products, centered by
   ``CenteredOperator``) fails above 1e-4 (max |dEV| / the largest EV);
   the error against the exact float64 truth (dense float64 Gram,
   subspace iteration) is reported with no bar, as is the process's peak
   host memory.
10. ``tiled_breakdown``: warm CUDA-event times of one ``mv_fast``,
   ``rmv_fast``, ``mv`` and ``rmv`` at kp 64 and of the overflow
   ``ell_spmm`` products, and ``tiled_idle``: the device idle share of a
   warm ``fit_transform``.
11. ``tiled_lanczos``: ``SparsePCABuilder``'s defaults and ``lanczos_block(8)`` on
   the tiled path's matrix and cached engine, each run whole: seconds,
   steps, kernel launches (counted from 0), and the explained variance
   against a float64 run of the same recurrence from the same start vector
   / block over float64 CSR products (fails above 1e-4) and against the
   float64 truth of the uncentered Gram (fails above 1e-5).
12. ``library``: one PyTorch call per kernel that computes the same
   function, timed with CUDA events and used nowhere in the port: the
   float32 CSR ``.to_dense()`` of one 8,192-row north-star slab
   (densify; its bf16 form too), float32 ``torch.sparse_csr_tensor``
   products ``X @ B`` and ``X^T @ C`` at kp 64 and 8 on the tiled path's
   matrix (spmm, rmv; bf16 too where torch takes it). ``tiled_bounds``:
   the stored slots of the engine's payload and the kernels' bounds.

The reference crate's preprocessing and masked-PCA pipeline, on the north
star's counts (after ``main_path``) and the tiled path's matrix:

13. ``stats``: both device padded-ELL layouts (host build, upload, widths,
   bytes: ``stats_layouts``), then every statistic per axis (nonzero,
   sum, sum of squares, variance, min / max, their masked forms with a
   seeded half mask, ``mean_batch_col`` / ``var_batch_row`` over the 64
   generator clusters, ``sum_row_n_top(50)``), timed beside its bound and
   held to float64 from the host CSR arrays: counts and min / max exact,
   the others at most 1e-6 of the largest |truth|.
14. ``pipeline`` (this slice's main path): ``sum_row`` -> ``normalize(lib,
   1e4, ROW)`` -> ``log1p_normalize`` -> the top 2,000 columns of
   ``var_col`` -> ``MaskedSparsePCABuilder``'s defaults (Lanczos, 'auto')
   cold and warm, then ``SVDMethod.random(10, 7, QR)`` on the cached
   engine. The engine must be ``GramPCAEngine`` on its float32 tier, with
   float32 densify slabs in its Gram pass (launches by output type,
   counted from 0). ``pipeline_ev``: stored values against a float64
   recompute (fail above 1e-6 relative, per value), the Lanczos EVs
   against the float64 UNCENTERED truth of the masked Gram and the
   randomized EVs against its CENTERED truth (fail above 1e-5), from one
   float64 Gram of the log-normalized matrix. ``log1p_ulp``: torch.log1p
   on the card over the normalized values, fail above 3 ULP.
15. ``sparse_engine``: ``engine("sparse")`` (``SparseOperator``) on the
   log-normalized matrix, ``lanczos_block(8)`` and the defaults, against
   the float64 uncentered truth (fail above 1e-5); its products at k 1, 8
   and 64 against float64 CSR products (1e-5), beside their bound and one
   float32 ``torch.sparse_csr_tensor`` product.
16. ``similarity``: cosine, euclidean and pearson ``pairwise`` over the
   first 50,000 rows of the pipeline's scores, manhattan and jaccard over
   5,000, timed beside their bound and held to float64 on 1,024 rows.
17. ``masked_tiled`` (inside the tiled path): ``MaskedSparsePCABuilder``
   with ``lanczos_block(8)`` on the tiled engine through
   ``MaskedOperator``, both kernels' launches counted from 0, EVs against
   the float64 uncentered truth of ``X[:, mask]`` (fail above 1e-5).

The JAX package's models beyond PCA:

18. ``streaming`` (after ``pipeline``, on the north star's counts):
   ``StreamingSparsePCA(n_components=50, n_features=30000)``,
   ``partial_fit`` over 131,072-row chunks, ``finalize``, ``transform``
   over the same chunks, densify launches counted from 0 (bf16 output in
   the fit, float32 in the transform: 2 x slabs), slab widths against
   those the ``kernel`` phase held, EV against ``main_path``'s float64
   truth (fail above 1e-5), the first chunk's scores against a float64
   ``(X - mu) V^T`` on the card (fail above 1e-5 of max |score|); the host
   build against the upload of the first chunk's slabs, and the device
   idle share of one ``partial_fit``. ``streaming_f32``: 16 slabs (a
   seeded sample of 131,072 rows) of the pipeline's log-normalized values
   (float32 densify and GEMM) against the float64 Gram of those rows (fail
   above 1e-5).
19. ``tsne``: ``tsne.run`` on ``benchmarks/tsne_large.py``'s blobs (10
   clusters, d 50, seed 0), perplexity 30, 500 epochs, knn mode at n =
   50,000 and exact mode at n = 10,000: the gradient at a seeded y against
   a float64 evaluation on the card (fail above 1e-4 of max |g|), two
   evaluations bit for bit equal, finite output, the silhouette of 5,000
   sampled points against the planted labels (fail below 0.7).

The mesh layer (``parallel/``, the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``), on a mesh of four entries that all
name this one card (``Mesh((cuda:0,) * 4)``: every slab's kernels and
every reduction run on it; no transfer between cards is measured). Each
case runs beside the single-card phase whose matrix and float64 truth it
reuses, after that phase's engine is freed, and prints ``mesh`` lines
with the card's name and power limit:

20. ``mesh`` ``gram`` (after ``main_path``): ``sharded_gram_pca`` on the
   north star's counts, cold and warm: EV within 1e-5 of the float64 truth
   and within 1e-6 (of the largest) of the single-card Gram fit, the first
   1,000 rows' scores within 1e-5 of max |score| of the single card's,
   densify launches = 2 x the slabs' sub-slabs (Gram pass, projection) at
   held widths; per-slab Gram and reduction ms, peak memory. ``sparse``:
   the gather engine (``ShardedSpMM``) with ``lanczos_block(8)`` on the
   same counts against the float64 UNCENTERED truth (1e-5). ``auto``:
   ``choose_sharded_engine`` must choose an engine whose payload fits ONE
   card's budget (four entries on one card share it).
21. ``mesh`` ``streaming`` (after ``streaming``): ``StreamingSparsePCA(
   mesh=)`` over the first two 131,072-row chunks (the smoke's time
   budget), beside a single-card stream over the same chunks: EV within
   1e-6 (of the largest) of it, the first chunk's scores within 1e-5 of
   max |score|, densify launches = slabs (bf16, fit) + slabs (float32,
   transform) at held widths, the idle share of a ``partial_fit``.
22. ``mesh`` ``dense`` (inside ``dense_path``): the builder's defaults
   (Lanczos) on ``ShardedDensified``, against the densified path's float64
   uncentered truth (1e-5); warm seconds and steps.
23. ``mesh`` ``tiled`` (inside ``tiled_path``): ``ShardedTiled``. Both
   kernels are first held against their plain versions on slab 0's
   payload at the path's operand shapes (``kernel_spmm`` /
   ``kernel_rmv`` lines, cases ``mesh_slab_*``) and timed beside one
   cuSPARSE product each at slab 0's rows (``mesh`` ``library_slab``:
   float32 ``torch.sparse_csr_tensor`` ``A @ B`` and ``A^T @ C``, kp 64
   and 8, bf16 where torch takes it); then the randomized fit
   at the tiled phase's seed (the same sketch) and ``lanczos_block(8)``,
   each EV within 1e-5 of the single-card fit's, launches as predicted
   from the slab count (randomized: 4 x 9 spmm, 4 x 8 rmv; block
   Lanczos: 4 x steps rmv, 4 x (steps + 1) spmm), and no launch at a
   shape that was not held; ms per product; ``auto`` as in case 20.
24. ``mesh`` ``tsne`` (inside ``tsne``): ``tsne.run(mesh=)`` in knn mode at
   50,000, 250 epochs (the smoke's time budget): the mesh gradient within
   1e-4 of max |g| of a float64 evaluation, bit for bit on repeat,
   silhouette at least 0.7, ms per epoch beside the single card's.

The single-cell workflow (cell 13: ``examples/scrna_pipeline.py``'s path
through the port's entry points):

25. ``scrna`` (after ``pipeline``, on cell 1's counts and the pipeline's
   log-normalized matrix, whose Gram engine it reuses):
   ``calculate_qc_metrics`` (counts and totals exact against the host CSR
   in float64), ``torch.expm1`` on the card (3 ULP), ``highly_variable_genes``
   (seurat, 2,000; ``dispersions_norm`` within 1e-5 of a float64 recompute,
   the mask the truth's away from the cutoff), ``MaskedSparsePCABuilder``'s
   defaults on that mask (warm; EV within 1e-5 of the float64 masked
   truth; its densify launches counted), ``neighbors.connectivities(E,
   15)`` (the IVF index: recall@15 >= 0.95 on 20,000 queries against the
   exact ``cross_knn``, itself against float64 on 1,000; memberships
   log2(15) within 1e-3; symmetric), ``leiden`` (native; quality within
   1e-6 of a float64 modularity), ``KMeans(64)``, ``UMAP`` (one epoch
   within 1e-4 of max |update| of a float64 CPU epoch with the same draws,
   bit for bit on repeat), ``recipe_zheng17`` on the counts (Z within
   1e-5 of max |Z| of a float64 recompute on 2,000 rows); every
   step's seconds, the IVF lists, launches and times, UMAP's ms per epoch,
   the peak memory, ARIs against the 64 planted clusters.
26. ``scrna_blobs`` (after ``tsne``, on its 50,000 blobs): exact
   ``connectivities`` -> ``leiden`` and ``KMeans(10, n_init=3)`` (ARI >=
   0.9), ``UMAP`` (silhouette >= 0.7), and on ``Mesh((cuda:0,) * 4)`` the
   graph identical to the single card's and Lloyd from the same centers
   within 1e-5.

The analysis surface (cell 14: the JAX package's modules after the
workflow), each phase with its seconds, peak memory and the card's name
and power limit:

27. ``de`` (after ``scrna``, on its log-normalized matrix and Leiden
   labels: the example's last call): ``rank_genes_groups`` with
   'wilcoxon', 't-test' and 't-test_overestim_var' (``pts=True``):
   grouped means and variances within 1e-6 of the largest |truth|, t
   within 1e-5 of max |t|, z of 64 seeded genes within 1e-4 of max(1,
   |z|) against float64 tie-averaged ranks (the JAX package's float32
   rank sums on the same genes reported beside it), each group's top 5
   the float64 top 5 away from ties, ``pts`` exact, a Wilcoxon block bit
   for bit on repeat; W, the block size and count; then 'logreg' on the
   first 100,000 rows, coefficients within 1e-4 of max |W| of a float64
   run of the same 300 steps from the same start.
28. ``metrics`` (in ``scrna`` and ``scrna_blobs``): ``silhouette_score`` of
   5,000 sampled scores vs float64 (1e-5); Moran's I / Geary's C of 64
   HVG columns over the connectivities vs float64 (1e-5);
   ``embedding_density`` of the UMAP layout per Leiden group vs float64
   (1e-5); on the blobs the full silhouette on one card and on
   ``Mesh((cuda:0,) * 4)`` (1e-6 apart), ARI and NMI vs the smoke's own,
   and ``lisi`` (5e-3), ``kbet`` (1e-3), ``silhouette_batch`` (1e-5) with
   mixed and with separated batches against float64 recomputes.
29. ``analysis`` (in ``scrna``): ``magic`` on the first 50,000 rows, 2,000
   HVGs and their scores (the densified route; 1e-5 of max vs a float64
   3-step diffusion), ``scrublet`` on one 10x lane with planted
   cross-cluster doublets (AUROC >= 0.75, from the JAX package's CPU run
   of ``tools/scrublet_bar.py``), ``score_genes`` of 50 genes (1e-6);
   on the blobs ``SpectralClustering(10)`` (ARI >= 0.9, float64
   eigen-residual <= 1e-4), ``diffmap(S, 15)`` (the same residual, the
   first eigenvalue 1 within 1e-5, finite pseudotime), ``mnn_correct`` of
   a planted batch shift (``tests/test_mnn.py``'s bar) and ``ingest``
   (accuracy >= 0.99).
30. ``lsi`` (inside ``tiled_path``, after its engine is freed): ``lsi(m,
   30)`` on cell 2's counts binarized: ``auto`` must take the tiled
   engine (TF-IDF: hi and lo payloads), every launched kernel shape held
   against the plain versions on both payloads, the launches added to
   the kernels line; ``lsi_ev``: singular values within 1e-4 of a float64
   run with the same sketch.
31. ``io`` (after ``scrna``): 20,000 of cell 1's cells written as a
   gzipped 10x mtx directory and read back by ``read_10x_mtx`` to the
   same CSR on the card; with ``h5py``, also ``write_h5ad`` ->
   ``read_h5ad`` and ``iter_h5ad_chunks`` (else ``"h5py": null``).
32. ``tracing`` (at the end of ``main_path``, on its cached Gram engine):
   ``utils.tracing.profile_trace`` into ``build/trace/`` around one warm
   ``fit_transform`` whose steps (engine lookup, fit, transform) are
   ``stage``s: the Chrome trace must name every stage and hold at least
   one densify kernel event, and the stage seconds must add up to the
   synchronised wall time within 10 %. Its densify launches join the
   kernels line.
33. ``harmony`` (after ``scrna``, on its 1,000,000 x 50 masked-PCA scores):
   two planted batches (a seeded half of the cells shifted by a seeded
   vector, half the median distance between the 64 planted cluster
   centroids), ``harmony`` with its defaults: one ``_kmeans_sweep`` and
   one ``_correct`` from the same state within 1e-5 (of max |R|, of max
   |Z|) of float64 on the card; a repeat of the whole run bit for bit;
   batch separation (``tests/test_harmony.py``'s) after below 0.3 x
   before; ``KMeans(64)`` on the corrected scores within 0.05 ARI of the
   unshifted scores' from the same centers.
34. ``mesh_pipeline`` (after ``de``, on cell 1's counts): ``ShardedSpMM``
   on ``Mesh((cuda:0,) * 4)``, then ``mesh_qc_metrics`` ->
   ``mesh_normalize_total(1e4)`` -> ``mesh_log1p`` ->
   ``mesh_highly_variable_genes`` (seurat, 2,000) -> ``mesh_scale`` ->
   ``mesh_rank_genes_groups`` (both t-tests, ``pts``) on the Leiden
   labels, each held to the single card's ``scrna`` / ``de`` results: QC
   counts exact, moments 1e-6 of the largest, ``dispersions_norm`` 1e-5
   and the mask away from the cutoff, t 1e-6 of max |t|, ``pts`` exact.
35. ``nmf`` (inside ``dense_path``, on its 400,000 x 30,000 counts and
   payload): ``NMF(20)`` with its defaults on the densified engine (the
   payload of the fits before it); its first 10 MU iterations (20 before
   the smoke's time cut) from the same ``W0, H0`` within 1e-4 (of max
   |W|, max |H|) of float64 CSR
   products on the card; ``reconstruction_err_`` within 1e-5 of a
   float64 recompute; then on the first 50,000 rows the gather engine
   and ``mesh=`` (80 iterations) against each other at the JAX test's
   bars (reconstruction error 1e-2, ``W H`` 2e-2).
36. ``draw_graph`` (after ``scrna_blobs``, on its 50,000-node graph):
   ForceAtlas2 with its defaults (500 iterations); the float32 forces at
   the seeded start and after 250 iterations within 1e-4 of max |F| of a
   float64 evaluation, two evaluations bit for bit equal; the layout
   finite, the planted blobs' separation above 2.0; on ``Mesh((cuda:0,) *
   4)`` 5 iterations from the same start within rtol 5e-3, atol 1e-2 of
   the single card, then 50 iterations (100 before the smoke's time
   cut; finite, separation above 2.0). The forces after 250 iterations
   are those of the public run's state (its iterations split there).
37. ``jax_layout`` (after ``kernel``): the three kernels on the JAX
   package's one-level tiled layout, ``sparse.convert.
   csr_to_tiled_ell_numpy``'s arrays transposed, contiguous and uploaded
   (``rows_padded_to=512``): the shapes of ``tests/test_pallas_kernels.py``
   (512 x 300 and 512 x 90 at ``col_tile`` 128, 1,024 x 700 at 256, kp
   128), then a 16,384 x 2,048 matrix built by ``coo_to_csr_numpy`` with
   planted groups that take ``wt`` to 40, at ``col_tile`` 128 and kp 64.
   Densify (float32 out), ``A @ B`` and ``A^T @ C`` run once each with
   the launch counts from 0 (the counts join the kernels line), then are
   held against their plain versions and against scipy's float64 dense
   matrix, ``X @ B`` and ``X.T @ C`` (fail above 1e-5 of the largest
   value), and launched again (fail unless bit for bit equal); each is
   timed beside its plain version and its bound.

Each kernel's ``bound_ms`` is the larger of the bytes it must move (each
input read once, each output written once) over 3.35 TB/s and its
float32 multiply-adds (2 x stored slots x kp) over 67 TFLOP/s. The
densify kernel's ``launches`` are those of the north star's cold fit plus
the streaming phase's (both streams), the mesh Gram fit's, the mesh
stream's, the scrna phase's masked fit, the tracing phase's warm fit
and the NMF gather route's init (a Gram engine); the tiled kernels' those of
the cold tiled fit, the ``lsi`` fit and the mesh tiled fits; all three add
the ``jax_layout`` phase's counted runs. The float64
Grams of integer counts are exact: int8 tensor-core products summed in
float64.

Then, as the last three lines: ``{"kernels": [...]}``, the card's
``name, power.limit`` from nvidia-smi, and ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero; with no CUDA device it exits 2
before printing any result.
"""

from __future__ import annotations

import functools
import json
import os
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
EV_FAIL = 1e-5  # the phase fails above this EV relative error
EV_TARGET = 1e-6  # BASELINE.json's explained-variance parity target
TPU_KERNELS = "single_algebra_tpu/ops/pallas/spmm_kernel.py"
KERNEL_SRC = "single_algebra_tpu_torch/csrc/tiled_ell_densify.cu"
TILED_SRC = "single_algebra_tpu_torch/csrc/tiled_ell_spmm.cu"
N_CELLS, N_GENES, K = 1_000_000, 30_000, 50  # the north star
TILED_CELLS, TILED_GENES = 500_000, 60_664  # the tiled path: all human genes
TILED_EV_FAIL = 1e-4  # the tiled phase fails above this EV error vs its f64 twin
DENSE_CELLS, DENSE_GENES = 400_000, 30_000  # the densified path: dense bf16 24 GB
DENSE_LO_CELLS = 200_000  # its non-bf16-exact variant: hi + lo, 12 GB each
RANDOMIZED_TRUTH_FAIL = 5e-3  # the q = 7 A-space sketch against the centered f64 truth
STREAM_CHUNK = 131_072  # rows per partial_fit / transform call: 16 slabs of 8,192
SCORE_REL_FAIL = 1e-5  # streaming scores vs a float64 recompute, of max |score|
TSNE_KNN_N, TSNE_EXACT_N, TSNE_EPOCHS = 50_000, 10_000, 500  # results_tsne_tpu.json's knn row
TSNE_GRAD_FAIL = 1e-4  # the float32 gradient vs a float64 evaluation, of max |g|
SIL_SAMPLE, SIL_FAIL = 5_000, 0.7  # silhouette sample and bar (the TPU run recorded 0.779)
MESH_ENTRIES = 4  # the mesh phases' entries, all on the one card
MESH_SINGLE_FAIL = 1e-6  # mesh Gram / stream EV vs the single-card fit, of the largest EV
MESH_SCORE_ROWS = 1_000  # the mesh Gram fit's score rows held to the single card's
MESH_STREAM_CHUNKS = 2  # the mesh stream's chunks (cell 10's first 262,144 rows)
MESH_TSNE_EPOCHS = 250  # the mesh t-SNE's epochs (the single card runs 500)
KERNEL_REL_FAIL = 1e-5  # spmm / rmv kernel vs plain, relative to max |plain|
JAX_LAYOUT_CASES = (  # n, p, k, density, col_tile, kp: tests/test_pallas_kernels.py's
    (512, 300, 16, 0.1, 128, 128),  # shapes, then 16,384 rows with planted (row, tile)
    (1024, 700, 60, 0.05, 256, 128),  # groups of 37 entries: wt 40
    (512, 90, 5, 0.3, 128, 128),
    (16384, 2048, 64, 0.01, 128, 64),
)
HVG = 2_000  # the pipeline's mask: the top columns of var_col (stands in for HVG selection)
NORM_TARGET = 1e4  # normalize's target row sum
STAT_REL_FAIL = 1e-6  # sum-type statistics vs float64, of the largest |truth|
VALUE_REL_FAIL = 1e-6  # log-normalized values vs a float64 recompute, per value
LOG1P_ULP_FAIL = 3.0  # the precise-log1p bound of tests/test_precise_math.py
SIM_ROWS, SIM_L1_ROWS, SIM_CHECK_ROWS = 50_000, 5_000, 1_024
SIM_FAIL = 1e-5
DEVICE = "cuda"  # where the pipeline phases put their matrices and operands
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA's data sheet)
F32_FLOP_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
SCRNA_HVG, SCRNA_NEIGHBORS, SCRNA_KMEANS = 2_000, 15, 64  # cell 13: examples/scrna_pipeline.py
SCRNA_RESOLUTION = 0.5  # Leiden's resolution in the example
SCRNA_RECALL_QUERIES, SCRNA_F64_ROWS = 20_000, 1_000  # IVF recall queries; float64 kNN rows
UMAP_EPOCHS, UMAP_REPEAT_EPOCHS = 200, 20  # the fit's epochs; the timed, repeated layout
ZHENG_ROWS, ZHENG_CHECK_ROWS, ZHENG_SCALE_MAX = 100_000, 2_000, 10.0  # recipe_zheng17 (rows: the time budget)
HVG_FAIL = 1e-5  # dispersions_norm vs float64, of the largest |truth|
RECALL_FAIL, RECALL_TIE = 0.95, 1e-5  # IVF recall@15 vs exact; a tie, relative
EXACT_KNN_F64_FAIL = 1e-4  # the exact float32 kNN's picks vs float64, of the k-th distance
MEMBERSHIP_FAIL = 1e-3  # a row's memberships vs log2(k)
MODULARITY_FAIL = 1e-6  # Leiden's quality vs a float64 recompute
UMAP_EPOCH_FAIL = 1e-4  # one card epoch vs float64, of max |update|
ZHENG_FAIL = 1e-5  # recipe_zheng17's Z vs float64, of max |Z|
ARI_FAIL = 0.9  # the blobs' clusterings against the planted labels
KMEANS_MESH_FAIL = 1e-5  # mesh Lloyd vs the single card's, of max |center|
INT8_GRAM_ROWS, INT8_GRAM_COLS = 16_384, 8_192  # the exact integer Gram's row chunk, column block
F64_GRAM_COLS = 4_096  # the float64 Gram's column block
DE_MOMENT_FAIL = 1e-6  # grouped means / variances vs float64, of the largest |truth|
DE_T_FAIL = 1e-5  # t vs float64, of max |t|
DE_Z_FAIL, DE_Z_GENES = 1e-4, 64  # Wilcoxon z vs float64 ranks, of max(1, |z|); genes checked
DE_TOP = 5  # each group's top names held to the float64 ranking
DE_LOGREG_ROWS, LOGREG_FAIL = 100_000, 1e-4  # logreg's rows; its coefficients vs float64
METRIC_SIL_ROWS, METRIC_FAIL = 5_000, 1e-5  # cell 13's silhouette sample; metrics vs float64
MORAN_COLS, DENSITY_GROUP_ROWS = 64, 20_000  # autocorrelation columns; densities checked per group
MESH_SIL_FAIL = 1e-6  # the mesh silhouette vs the single card's, of the largest |s|
# LISI of 1,000 rows vs float64 (exact float64 kNN), of the largest: at |x|^2 ~ 5,000 the
# float32 kNN's d^2 carry ~3e-3 of cancellation and part from float64 at the 90th neighbor
METRIC_CHECK_ROWS, LISI_FAIL = 1_000, 5e-3
KBET_K, KBET_FAIL = 25, 1e-3  # kBET's neighbors; its acceptance vs float64 kNN counts
MAGIC_ROWS, MAGIC_FAIL = 50_000, 1e-5  # magic's rows; vs a float64 diffusion, of max |value|
SCRUBLET_ROWS, SCRUBLET_RATE = 20_000, 0.06  # one 10x lane; its planted doublet share
SCRUBLET_AUROC_FAIL = 0.75  # the JAX package's CPU run at 5,000 rows: 0.806 (tools/scrublet_bar.py)
SCORE_GENES, SCORE_FAIL = 50, 1e-6  # score_genes' signature; vs float64, of max |score|
EIG_RESIDUAL_FAIL = 1e-4  # spectral / diffmap eigenvectors: float64 ||T v - lambda v||
DIFFMAP_KRYLOV = 1_200  # diffmap's Krylov dimension: its default 120 leaves the blobs'
# clustered within-blob modes (0.65-0.67) at residuals ~3e-2
MNN_SHIFT, INGEST_FAIL = 5.0, 0.99  # the planted batch shift; ingest's accuracy
LSI_COMPONENTS, LSI_FAIL = 30, 1e-4  # lsi's components; singular values vs a same-sketch f64 run
IO_ROWS = 20_000  # the io phase's lane
TRACE_DIR = os.path.join(ROOT, "build", "trace")  # the tracing phase's Chrome trace
TRACE_SUM_FAIL = 0.10  # the stage seconds vs the synchronised wall time, relative
HARMONY_STEP_FAIL = 1e-5  # one sweep / one correction vs float64, of max |R| / max |Z|
HARMONY_SEP_RATIO, HARMONY_ARI_DROP = 0.3, 0.05  # tests/test_harmony.py's bars
MESH_MOMENT_FAIL, MESH_T_FAIL = 1e-6, 1e-6  # mesh stages vs the single card's
NMF_K, NMF_F64_ITERS = 20, 10  # NMF's components; MU iterations held to float64 (20,
# cut to 10 for the smoke's time: PERF.md section 4)
NMF_F64_FAIL, NMF_LOSS_FAIL = 1e-4, 1e-5  # of max |W|, max |H|; the loss, relative
NMF_SUB_ROWS, NMF_SUB_ITER = 50_000, 80  # the gather route and the mesh
NMF_ERR_FAIL, NMF_WH_FAIL = 1e-2, 2e-2  # tests/test_nmf.py's mesh bars
FA2_FORCE_FAIL, FA2_SEP_FAIL = 1e-4, 2.0  # forces vs float64, of max |F|; separation
FA2_CHECK_ITER, FA2_MESH_SHORT, FA2_MESH_ITER = 250, 5, 50  # the mesh run: 100, cut to 50
# for the smoke's time (PERF.md section 4)


def bound(nbytes: float, flops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the float32 rate."""

    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def run(cmd) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"
    return (res.stdout or res.stderr).strip()


def card_line() -> str:
    return run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])


@functools.cache
def card() -> str:
    """``card_line()``, read once: printed beside every mesh number."""

    return card_line()


def phase_env(torch) -> None:
    try:
        import triton  # noqa: F401

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    from single_algebra_tpu_torch.ops.cuda_lib import nvcc

    emit(
        "env",
        card=card_line(),
        torch=torch.__version__,
        torch_cuda=torch.version.cuda,
        nvcc=run([nvcc(), "--version"]).splitlines()[-1:],
        triton=triton_version,
        cutlass_include=os.path.isdir("/usr/local/cutlass/include"),
        python=sys.version.split()[0],
    )


def phase_build() -> None:
    """Every kernel library, one nvcc per source, all started together;
    the ptxas report per kernel (registers, shared memory, spills)."""

    from single_algebra_tpu_torch.ops import cuda_lib, densify, spmm_kernel

    t0 = time.perf_counter()
    cuda_lib.build_all(verbose=True)
    cuda_lib.load("tiled_ell_densify", densify._bind)
    cuda_lib.load("tiled_ell_spmm", spmm_kernel._bind)
    ptxas = {}
    for lib, log in cuda_lib.build_logs.items():
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and ("Used" in line or "spill" in line):
                ptxas.setdefault(f"{lib}:{kernel}", []).append(line.split(":", 1)[-1].strip())
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)


def _time_ms(torch, fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _densify_payload(torch, gen, ntiles, wt, R, ct, *, dup=False, bad=False, frac=False):
    """A random transposed bucket payload on the card, half its slots
    padding (0, 0); optionally few distinct ids per group (duplicates),
    ids outside [0, ct), fractional values."""

    dev = torch.device("cuda")
    vals = torch.randint(1, 60, (ntiles * wt, R), generator=gen, device=dev).float()
    if frac:
        vals = vals + 0.25 * torch.rand(vals.shape, generator=gen, device=dev)
    ids = torch.randint(0, 4 if dup else ct, (ntiles * wt, R), generator=gen, device=dev)
    if bad:
        ids[torch.rand(ids.shape, generator=gen, device=dev) < 0.1] = ct + 3
        ids[torch.rand(ids.shape, generator=gen, device=dev) < 0.05] = -1
    pad = torch.rand(vals.shape, generator=gen, device=dev) < 0.5
    vals[pad] = 0.0
    ids[pad] = 0
    return vals, ids.int()


def phase_kernel(torch) -> dict:
    """The densify kernel against its plain version AND against the
    one-warp kernel (the port's first densify kernel), bit for bit, on
    small cases: wt 4, 8, 16, 32 and 40 (past 16 the kernel takes a row 32
    slots at a time), duplicate ids, ids outside the tile, a slab at a
    non-zero offset that is not a whole number of blocks, col_tile 256 and
    128. Then the north-star slab shapes (int8, bf16, f32; 30,720 x 8,192,
    wt 8, 16 and 32: every bucket width of that engine; 24 and 40: the
    streaming payload's widths, its slab's densest group rounded to 8)
    compared the same way and timed, each with its bound. -> the headline
    numbers and ``slab_widths``, the widths held at the slab shape."""

    from single_algebra_tpu_torch.ops.densify import (
        tiled_ell_densify_t, tiled_ell_densify_t_plain, tiled_ell_densify_t_warp,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dtypes = (torch.int8, torch.bfloat16, torch.float32)

    def same_bits(a, b):
        return bool(torch.equal(a.view(torch.uint8), b.view(torch.uint8)))

    def compare(case, vals, ids, out_dtype, kw):
        got = tiled_ell_densify_t(vals, ids, out_dtype=out_dtype, **kw)
        warp = tiled_ell_densify_t_warp(vals, ids, out_dtype=out_dtype, **kw)
        want = tiled_ell_densify_t_plain(vals, ids, out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        line = dict(case=case, out_dtype=str(out_dtype).split(".")[-1], shape=list(got.shape),
                    equals_plain=same_bits(got, want), equals_warp_kernel=same_bits(got, warp),
                    warp_kernel_equals_plain=same_bits(warp, want), max_abs_err=err)
        if not (line["equals_plain"] and line["equals_warp_kernel"]):
            emit("kernel", **line)
            raise AssertionError(f"densify kernel differs ({case}, {out_dtype}): {line}")
        return line

    worst = 0.0
    small = (  # case, ntiles, wt, ct, payload rows, slab offset, slab rows, dup, bad ids
        ("wt4", 6, 4, 256, 4096, 0, 2048, False, False),
        ("wt8_offset_ragged", 6, 8, 256, 4096, 1056, 2976, False, False),
        ("wt16_dup", 6, 16, 256, 4096, 2048, 2048, True, False),
        ("wt8_bad_ids", 6, 8, 256, 2048, 0, 2048, False, True),
        ("wt16_ct128_dup_bad", 9, 16, 128, 2048, 512, 1024, True, True),
        ("wt32_dup_bad_ragged", 6, 32, 256, 4096, 1056, 2976, True, True),
        ("wt40_ct128_dup", 5, 40, 128, 2048, 512, 1024, True, False),
    )
    for case, ntiles, wt, ct, R, off, rows, dup, bad in small:
        vals, ids = _densify_payload(torch, gen, ntiles, wt, R, ct, dup=dup, bad=bad, frac=True)
        kw = dict(wt=wt, ntiles=ntiles, col_tile=ct, row_offset=off, rows=rows)
        for out_dtype in dtypes:
            line = compare(case, vals, ids, out_dtype, kw)
            emit("kernel", wt=wt, col_tile=ct, row_offset=off, **line)
            worst = max(worst, line["max_abs_err"])

    ntiles, ct, slab = 120, 256, 8192
    headline = None
    slab_cases = (("slab_wt8", 8), ("slab_wt16", 16), ("slab_wt24", 24), ("slab_wt32", 32),
                  ("slab_wt40", 40), ("slab_dup_ids", 8))
    for case, wt in slab_cases:
        # a bucket payload two slabs wide; the kernel reads the second slab
        # through its offset, as the Gram engine does
        vals, ids = _densify_payload(torch, gen, ntiles, wt, 2 * slab, ct,
                                     dup=case == "slab_dup_ids", frac=case == "slab_dup_ids")
        kw = dict(wt=wt, ntiles=ntiles, col_tile=ct, row_offset=slab, rows=slab)
        for out_dtype in dtypes:
            line = compare(case, vals, ids, out_dtype, kw)
            ms = _time_ms(torch, lambda: tiled_ell_densify_t(vals, ids, out_dtype=out_dtype, **kw), 20)
            warp_ms = _time_ms(
                torch, lambda: tiled_ell_densify_t_warp(vals, ids, out_dtype=out_dtype, **kw), 20)
            plain_ms = _time_ms(
                torch, lambda: tiled_ell_densify_t_plain(vals, ids, out_dtype=out_dtype, **kw), 3)
            item = torch.empty((), dtype=out_dtype).element_size()
            moved = ntiles * ct * slab * item + ntiles * wt * slab * 8
            bd = bound(moved)
            emit("kernel", wt=wt, ms=ms, warp_kernel_ms=warp_ms, plain_ms=plain_ms,
                 share_of_bound=bd["bound_ms"] / ms, hbm_gb_per_s=moved / ms / 1e6, **bd, **line)
            worst = max(worst, line["max_abs_err"])
            if case == "slab_wt8" and out_dtype == torch.int8:
                headline = dict(ms=ms, plain_ms=plain_ms, **bd)
    return dict(max_abs_err=worst, slab_widths=sorted({wt for _, wt in slab_cases}), **headline)


def _jax_layout_matrix(n, p, density, seed):
    """CSR arrays of a seeded matrix: ``tests/test_pallas_kernels.py``'s recipe
    up to 1,024 rows; past that random COO triplets plus 37 entries in one
    128-column tile of each of 8 rows, through ``coo_to_csr_numpy`` (the
    duplicate pairs summed), so the densest (row, tile) group pads to wt 40."""

    import numpy as np
    import scipy.sparse as sp

    from single_algebra_tpu_torch.sparse import convert as cv

    rng = np.random.default_rng(seed)
    if n <= 1024:
        X = sp.random(n, p, density=density, format="csr", dtype=np.float64,
                      random_state=rng, data_rvs=rng.random).astype(np.float32)
        return X.indptr.astype(np.int64), X.indices.astype(np.int32), X.data
    nnz = int(n * p * density)
    rows = [rng.integers(0, n, nnz)]
    cols = [rng.integers(0, p, nnz)]
    for r in rng.choice(n, 8, replace=False):
        tile = int(rng.integers(0, p // 128))
        rows.append(np.full(37, r))
        cols.append(tile * 128 + rng.choice(128, 37, replace=False))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.random(len(rows)).astype(np.float32)
    return cv.coo_to_csr_numpy(rows, cols, vals, n, p)


def phase_jax_layout(torch, densify_result: dict, tiled_result: dict) -> dict:
    """The three kernels on ``csr_to_tiled_ell_numpy``'s layout (the JAX
    package's Pallas kernels' own), at the JAX Pallas tests' shapes and one
    16,384-row case past wt 32 at col_tile 128. The kernels run once per
    case with the launch counts from 0; then each result is held to its
    plain version and to scipy's float64 result (``KERNEL_REL_FAIL`` of the
    largest value), a second launch must give the same bits, and each
    kernel is timed (CUDA events) beside its plain version and its bound.
    The worst abs errors join ``densify_result`` and ``tiled_result``.
    -> the counted launches by kernel."""

    import numpy as np
    import scipy.sparse as sp

    from single_algebra_tpu_torch.ops import cuda_lib
    from single_algebra_tpu_torch.ops.densify import (
        tiled_ell_densify_t, tiled_ell_densify_t_plain,
    )
    from single_algebra_tpu_torch.ops.spmm_kernel import (
        tiled_ell_rmv_t, tiled_ell_rmv_t_plain, tiled_ell_spmm_t, tiled_ell_spmm_t_plain,
    )
    from single_algebra_tpu_torch.sparse import convert as cv

    dev = torch.device("cuda")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = []
    for i, (n, p, k, density, ct, kp) in enumerate(JAX_LAYOUT_CASES):
        t0 = time.perf_counter()
        indptr, indices, data = _jax_layout_matrix(n, p, density, seed=i)
        td, tl, wt, nt = cv.csr_to_tiled_ell_numpy(indptr, indices, data, n, p, col_tile=ct,
                                                   rows_padded_to=512)
        host_s = time.perf_counter() - t0
        R = td.shape[0]
        rng = np.random.default_rng(100 + i)
        B = rng.standard_normal((p, k)).astype(np.float32)
        C = rng.standard_normal((n, k)).astype(np.float32)
        Bt = np.zeros((kp, nt * ct), np.float32)
        Bt[:k, :p] = B.T
        Ct = np.zeros((kp, R), np.float32)
        Ct[:k, :n] = C.T
        X = sp.csr_matrix((data.astype(np.float64), indices, indptr), shape=(n, p))
        cases.append(dict(
            case=f"{n}x{p}_ct{ct}", n=n, p=p, k=k, kp=kp, ct=ct, wt=wt, nt=nt, R=R,
            nnz=len(indices), host_s=host_s, X=X, B=B, C=C, td=put(td.T), tl=put(tl.T),
            Bt=put(Bt), Ct=put(Ct)))
    if max(c["wt"] for c in cases) <= 32 or cases[-1]["ct"] != 128:
        raise AssertionError(f"no case past wt 32 at col_tile 128: {[c['wt'] for c in cases]}")

    def kernels(c):
        kw = dict(wt=c["wt"], ntiles=c["nt"], col_tile=c["ct"], block_rows=512)
        dkw = dict(wt=c["wt"], ntiles=c["nt"], col_tile=c["ct"], out_dtype=torch.float32)
        return (
            ("tiled_ell_densify_t", lambda: tiled_ell_densify_t(c["td"], c["tl"], **dkw),
             lambda: tiled_ell_densify_t_plain(c["td"], c["tl"], **dkw)),
            ("tiled_ell_spmm_t", lambda: tiled_ell_spmm_t(c["td"], c["tl"], c["Bt"], **kw),
             lambda: tiled_ell_spmm_t_plain(c["td"], c["tl"], c["Bt"], **kw)),
            ("tiled_ell_rmv_t", lambda: tiled_ell_rmv_t(c["td"], c["tl"], c["Ct"], **kw),
             lambda: tiled_ell_rmv_t_plain(c["td"], c["tl"], c["Ct"], **kw)),
        )

    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    for c in cases:
        c["out"] = {name: fn() for name, fn, _ in kernels(c)}
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    if any(launches[name] != len(cases) for name in launches):
        raise AssertionError(f"jax_layout: {launches} launches, expected {len(cases)} each")

    for c in cases:
        X, n, p, k = c["X"], c["n"], c["p"], c["k"]
        truth = {  # scipy, float64, in each kernel's orientation
            "tiled_ell_densify_t": (X.T.toarray(), (p, n)),
            "tiled_ell_spmm_t": ((X @ c["B"].astype(np.float64)).T, (k, n)),
            "tiled_ell_rmv_t": (X.T @ c["C"].astype(np.float64), (p, k)),
        }
        payload = c["td"].numel() * 8  # float32 values + int32 ids
        flops = 2.0 * c["nnz"] * c["kp"]
        moved = {
            "tiled_ell_densify_t": (payload + c["nt"] * c["ct"] * c["R"] * 4, 0.0),
            "tiled_ell_spmm_t": (payload + c["Bt"].numel() * 4 + c["kp"] * c["R"] * 4, flops),
            "tiled_ell_rmv_t": (payload + c["Ct"].numel() * 4 + c["nt"] * c["ct"] * c["kp"] * 4,
                                flops),
        }
        for name, fn, plain in kernels(c):
            got = c["out"][name]
            want = plain()
            ref, (a, b) = truth[name]
            top = max(float(want.abs().max()), 1e-30)
            abs_err = float((got - want).abs().max())
            ref_err = float(np.abs(got[:a, :b].double().cpu().numpy() - ref).max())
            ref_rel = ref_err / max(float(np.abs(ref).max()), 1e-30)
            repeat_equal = bool(torch.equal(fn(), got))
            ms, plain_ms = _time_ms(torch, fn, 10), _time_ms(torch, plain, 2)
            emit("jax_layout", kernel=name, case=c["case"], n=n, p=p, rows_padded=c["R"],
                 col_tile=c["ct"], wt=c["wt"], ntiles=c["nt"], kp=c["kp"], nnz=c["nnz"],
                 host_layout_s=c["host_s"], rel_err=abs_err / top, max_abs_err=abs_err,
                 equals_plain=bool(torch.equal(got, want)), scipy_rel_err=ref_rel,
                 repeat_equal=repeat_equal, ms=ms, plain_ms=plain_ms, **bound(*moved[name]))
            if not (abs_err <= KERNEL_REL_FAIL * top and ref_rel <= KERNEL_REL_FAIL
                    and repeat_equal):
                raise AssertionError(
                    f"jax_layout {name} {c['case']}: rel err {abs_err / top} vs plain, "
                    f"{ref_rel} vs scipy, repeat_equal={repeat_equal}")
            if name == "tiled_ell_densify_t":
                entry = densify_result
            else:
                entry = tiled_result.setdefault(name, dict(max_abs_err=0.0))
            entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
            del want
        del c["out"], c["td"], c["tl"], c["Bt"], c["Ct"]
    torch.cuda.empty_cache()
    return launches


def phase_gram_tiers(torch) -> None:
    """The three Gram tiers on the card (blocked path, pp > 4096) against a
    float64 host Gram of the same matrix."""

    import numpy as np
    import scipy.sparse as sp

    from single_algebra_tpu_torch import SparseMatrix
    from single_algebra_tpu_torch.linalg.gram import GramPCAEngine, gram_matrix

    rng = np.random.default_rng(11)
    base = sp.random(20000, 4500, density=0.01, format="csr", random_state=rng,
                     dtype=np.float64)
    for tier, data in (
        ("int8", np.round(base.data * 100)),
        ("bf16", np.round(base.data * 127) + 128),
        ("f32", base.data),
    ):
        X = sp.csr_matrix((data.astype(np.float32), base.indices, base.indptr),
                          shape=base.shape)
        m = SparseMatrix.from_scipy(X, device="cuda")
        eng = GramPCAEngine.from_matrix(m)
        G = gram_matrix(eng)[: X.shape[1], : X.shape[1]].cpu().numpy()
        X64 = X.astype(np.float64)
        ref = (X64.T @ X64).toarray()
        rel = float(np.abs(G - ref).max() / np.abs(ref).max())
        emit("gram_tiers", tier=tier, exact=eng.meta[3], i8=eng.meta[4],
             p_padded=eng.p_padded, rel_err=rel)
        limit = 0.0 if tier == "int8" else 1e-6
        if rel > limit:
            raise AssertionError(f"{tier} Gram rel err {rel} > {limit}")


def csr_dense_rows(torch, X, r0: int, r1: int, dtype, device="cuda"):
    """Rows ``[r0, r1)`` of the host CSR ``X`` as a dense tensor on
    ``device``, independent of the port."""

    import numpy as np

    lo, hi = int(X.indptr[r0]), int(X.indptr[r1])
    counts = torch.from_numpy(np.diff(X.indptr[r0:r1 + 1]).astype(np.int64)).to(device)
    rows = torch.repeat_interleave(torch.arange(r1 - r0, device=device), counts)
    cols = torch.from_numpy(X.indices[lo:hi].astype(np.int64)).to(device)
    D = torch.zeros((r1 - r0, X.shape[1]), dtype=dtype, device=device)
    D.index_put_((rows, cols), torch.from_numpy(X.data[lo:hi]).to(device, dtype),
                 accumulate=True)
    return D


def _int8_exact(X) -> bool:
    """The stored values are integers in [-127, 127] and the width a
    multiple of 8: the Gram is then exact as int8 products."""

    import numpy as np

    d = X.data
    return (X.shape[1] % 8 == 0 and d.size > 0 and float(np.abs(d).max()) <= 127
            and bool(np.all(d == np.round(d))))


def _mirror_upper(G, block: int) -> None:
    """Fill the part of the symmetric ``G`` below its diagonal blocks of
    ``block`` columns from the part above them."""

    p = G.shape[0]
    for c0 in range(0, p, block):
        c1 = min(c0 + block, p)
        G[c1:, c0:c1] = G[c0:c1, c1:].T


def f64_gram(torch, X, chunk: int = 4096, device="cuda"):
    """(G, mu): the float64 Gram ``X^T X`` of CSR row chunks and the column
    means, on the card and independent of the port. Integer values in
    [-127, 127] (counts) take the int8 tensor cores: ``torch._int_mm`` of
    16,384-row chunks gives exact int32 partials (16,384 x 127^2 < 2^31),
    summed in float64 (exact below 2^53): the exact Gram, ~20x faster than
    the float64 GEMMs that other values take. Either way only the column
    blocks on and above the diagonal are multiplied; the rest is their
    transpose."""

    import gc

    gc.collect()  # operators the callers dropped, before a [p, p] float64
    n, p = X.shape
    G = torch.zeros((p, p), dtype=torch.float64, device=device)
    colsum = torch.zeros(p, dtype=torch.float64, device=device)
    if _int8_exact(X):
        for r0 in range(0, n, INT8_GRAM_ROWS):
            D = csr_dense_rows(torch, X, r0, min(r0 + INT8_GRAM_ROWS, n), torch.float32, device)
            colsum += D.sum(dim=0, dtype=torch.float64)
            rows = D.shape[0]
            At = torch.zeros((p, rows + (-rows) % 8), dtype=torch.int8, device=device)
            At[:, :rows] = D.T.to(torch.int8)
            del D
            for c0 in range(0, p, INT8_GRAM_COLS):
                c1 = min(c0 + INT8_GRAM_COLS, p)
                G[:c1, c0:c1] += torch._int_mm(At[:c1], At[c0:c1].T).double()
            del At
        _mirror_upper(G, INT8_GRAM_COLS)
        return G, colsum / n
    for r0 in range(0, n, chunk):
        D = csr_dense_rows(torch, X, r0, min(r0 + chunk, n), torch.float64, device)
        for c0 in range(0, p, F64_GRAM_COLS):
            c1 = min(c0 + F64_GRAM_COLS, p)
            G[c0:c1, c0:].addmm_(D[:, c0:c1].T, D[:, c0:])
        colsum += D.sum(dim=0)
    _mirror_upper(G, F64_GRAM_COLS)
    return G, colsum / n


def f64_topk(torch, G, k: int):
    """Top-k eigenvalues of the PSD float64 ``G``: subspace iteration with
    a Rayleigh-Ritz step (``eigvalsh`` of the projected matrix) until the
    Ritz values stop moving (cuSOLVER's ``eigvalsh`` refuses a whole
    30,000-wide matrix); -> (values, iterations)."""

    p = G.shape[0]
    b = min(2 * k + 28, p)
    gen = torch.Generator(device=G.device)
    gen.manual_seed(1)
    Q = torch.linalg.qr(torch.randn((p, b), generator=gen, dtype=torch.float64,
                                    device=G.device))[0]
    Z, prev = G @ Q, None
    for it in range(500):
        Q = torch.linalg.qr(Z)[0]
        Z = G @ Q
        ritz = torch.linalg.eigvalsh(Q.T @ Z).flip(0)[:k]
        if prev is not None and float(((ritz - prev).abs() / ritz[0]).max()) < 1e-13:
            break
        prev = ritz
    return ritz, it + 1


def f64_truth_ev(torch, X, k: int, chunk: int = 4096, device="cuda", uncentered=False,
                 cols=None, gram=None):
    """Top-k explained variances in float64 from the dense float64 Gram:
    of the centered matrix -> (ev, iterations), or with ``uncentered`` of
    both the raw matrix (what the Lanczos method solves: s^2 / (n - 1))
    and the centered one, from one Gram -> (ev_raw, ev_centered,
    iterations of each). ``cols`` restricts both to a column subset (a
    submatrix of the Gram); ``gram`` = ``f64_gram``'s (G, mu), computed
    once by the caller and left as it is (with ``cols``)."""

    n = X.shape[0]
    G, mu = f64_gram(torch, X, chunk, device) if gram is None else gram
    if cols is not None:
        idx = torch.as_tensor(cols, device=G.device)
        G, mu = G[idx][:, idx], mu[idx]  # copies
    elif gram is not None:
        raise ValueError("a shared Gram is centered in place: pass cols")
    raw = f64_topk(torch, G, k) if uncentered else None
    G.addr_(mu, mu, alpha=-n)  # centered in place: no [p, p] temporaries
    ritz, iters = f64_topk(torch, G, k)
    ev = (ritz / (n - 1)).cpu().numpy()
    if not uncentered:
        return ev, iters
    return (raw[0] / (n - 1)).cpu().numpy(), ev, (raw[1], iters)


def phase_breakdown(torch, eng, pca, k: int) -> None:
    """Where a full pass goes on the card (warm, CUDA events): the densify
    kernel alone over every slab (and the one-warp kernel over the same
    slabs), the whole Gram pass (densify + int8/bf16/f32 contraction), the
    p-space solve and the projection pass."""

    from single_algebra_tpu_torch.linalg import gram as g
    from single_algebra_tpu_torch.ops.densify import tiled_ell_densify_t_warp

    slab = g._slab_for(eng.shape[0])
    exact, i8 = eng.meta[3], eng.meta[4]
    out_dtype = torch.int8 if i8 else (torch.bfloat16 if exact else torch.float32)
    slabs = [(b, i) for b, (_, rc) in enumerate(eng.bwidths) for i in range(rc // slab)]

    def timed(fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3, out

    def densify_all(dtype):
        for b, i in slabs:
            eng._densify(b, i, dtype)  # each slab is dropped before the next

    def densify_all_warp_kernel(dtype):
        # the same slabs through the one-warp kernel (the port's first
        # densify kernel), for a comparison inside one run
        for b, i in slabs:
            tiled_ell_densify_t_warp(
                eng.bdata[b], eng.blocal[b], wt=eng.bwidths[b][0], ntiles=eng.meta[1],
                col_tile=eng.meta[2], out_dtype=dtype, row_offset=i * slab, rows=slab)

    densify_s, _ = timed(lambda: densify_all(out_dtype))
    gram_s, G = timed(lambda: g.gram_matrix(eng))
    mean = pca._mean_device()
    solve_s, (s, vt) = timed(lambda: g._solve_topk(
        G, torch.nn.functional.pad(mean.float(), (0, G.shape[0] - mean.shape[0])),
        eng.shape[0], 42, k=k, center=True, oversamples=10, iters=7))
    Vp = torch.zeros((eng.p_padded, k), dtype=torch.float32, device=G.device)
    Vp[: vt.shape[1]] = vt.T
    project_s, _ = timed(lambda: eng._project_bucketed(Vp))
    project_densify_s, _ = timed(lambda: densify_all(torch.float32))
    warp_s, _ = timed(lambda: densify_all_warp_kernel(out_dtype))
    warp_f32_s, _ = timed(lambda: densify_all_warp_kernel(torch.float32))
    emit("breakdown", slabs=len(slabs), densify_gram_dtype_s=densify_s,
         gram_pass_s=gram_s, solve_s=solve_s, projection_pass_s=project_s,
         densify_f32_s=project_densify_s, densify_gram_dtype_warp_kernel_s=warp_s,
         densify_f32_warp_kernel_s=warp_f32_s)


def device_idle(torch, fn, top: int = 0) -> dict:
    """One ``torch.profiler`` window around ``fn``: its wall time (host
    clock, synchronized, profiler on), the time in which the card ran at
    least one kernel, copy or memset (the union of the device events'
    intervals, so overlapping events count once and host-side op rows
    never count), and the idle share, 1 - busy / wall. ``top`` > 0 adds
    the device seconds of the ``top`` busiest device event names."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        raise AssertionError("the profiler window recorded no device event")
    busy_us, run_start, run_end = 0.0, spans[0][0], spans[0][1]
    for start, end in spans[1:]:
        if start > run_end:
            busy_us += run_end - run_start
            run_start = start
        run_end = max(run_end, end)
    busy_s = (busy_us + run_end - run_start) / 1e6
    out = dict(wall_s=wall_s, device_busy_s=busy_s, device_events=len(spans),
               idle_share=1.0 - busy_s / wall_s)
    if top:
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
        out["top_device_s"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    return out


def phase_idle(torch, eng, builder, m) -> None:
    """Device idle share of the Gram pass and of a warm fit_transform."""

    from single_algebra_tpu_torch.linalg.gram import gram_matrix

    emit("idle", gram_pass=device_idle(torch, lambda: gram_matrix(eng)),
         warm_fit_transform=device_idle(torch, lambda: builder().build().fit_transform(m)))


def _generate_counts(n: int, p: int):
    """``cluster_counts_big(n, p)`` as every cell draws it (64 clusters, seed
    7, density 0.01) -> (X, seconds)."""

    sys.path.insert(0, ROOT)
    from benchmarks._datagen import cluster_counts_big

    t0 = time.perf_counter()
    X = cluster_counts_big(n, p, n_clusters=64, seed=7, density=0.01)
    return X, time.perf_counter() - t0


class CountsWorker:
    """The cells' count matrices, drawn one after another on one worker
    thread while the phases before them run (the draws are numpy and scipy
    work, much of it outside the interpreter lock; a worker process would
    hand each matrix back through a pipe, copied under the lock).
    ``get(n, p)`` -> ``(X, gen_s, wait_s)``: the worker's seconds and the
    phase's wait. A shape not queued (a phase run alone) is drawn on the
    calling thread."""

    def __init__(self, shapes=()):
        self._pool, self._queued = None, {}
        if shapes:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(1)
            self._queued = {shape: self._pool.submit(_generate_counts, *shape)
                            for shape in shapes}

    def get(self, n: int, p: int):
        t0 = time.perf_counter()
        queued = self._queued.pop((n, p), None)
        X, gen_s = queued.result() if queued is not None else _generate_counts(n, p)
        return X, gen_s, time.perf_counter() - t0

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)


def phase_main_path(torch, held_widths, data=None) -> tuple:
    """The main path once, through the user-facing entry points.
    ``held_widths``: the bucket widths at which the ``kernel`` phase held
    the densify kernel against its plain version at the slab shape;
    ``data``: the ``CountsWorker`` holding its matrix."""

    import numpy as np

    sys.path.insert(0, ROOT)
    from single_algebra_tpu_torch import SparseMatrix, SparsePCABuilder
    from single_algebra_tpu_torch.linalg.gram import GramPCAEngine, _slab_for
    from single_algebra_tpu_torch.ops import densify
    from single_algebra_tpu_torch.types import PowerIterationNormalizer, SVDMethod

    n, p, k = N_CELLS, N_GENES, K
    X, gen_s, gen_wait_s = (data or CountsWorker()).get(n, p)
    t0 = time.perf_counter()
    m = SparseMatrix.from_scipy(X, device="cuda")
    from_scipy_s = time.perf_counter() - t0

    def builder():
        return (SparsePCABuilder().n_components(k)
                .svd_method(SVDMethod.random(10, 7, PowerIterationNormalizer.QR)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    densify.reset_launch_counts()
    t0 = time.perf_counter()
    pca = builder().build()
    T = pca.fit_transform(m)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = densify.launch_counts["tiled_ell_densify_t"]
    peak = torch.cuda.max_memory_allocated()
    eng = m._operator_cache.get("auto")
    ev = np.asarray(pca.explained_variance_, np.float64)
    # read after the cold window: the cold fit made and cached every gate
    emit("data", n=n, p=p, nnz=m.nnz, gen_s=gen_s, gen_wait_s=gen_wait_s,
         from_scipy_s=from_scipy_s,
         int8_exact=m.values_int8_exact())

    t0 = time.perf_counter()
    pca2 = builder().build()
    T2 = pca2.fit_transform(m)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    if not isinstance(eng, GramPCAEngine):
        raise AssertionError(f"engine 'auto' built {type(eng).__name__}, not GramPCAEngine")
    if launches <= 0:
        raise AssertionError("the main path launched no densify kernel")
    # a cold fit densifies every slab twice (Gram pass, projection)
    slab = _slab_for(n)
    by_wt = {int(wt): 2 * (rc // slab) for wt, rc in eng.bwidths}
    if sum(by_wt.values()) != launches or not set(by_wt) <= set(held_widths):
        raise AssertionError(f"densify launches {launches} over bucket widths {by_wt}: the "
                             f"kernel phase held widths {held_widths} only")
    if tuple(T.shape) != (n, k) or not bool(torch.isfinite(T).all()):
        raise AssertionError(f"scores: shape {tuple(T.shape)}, finite={bool(torch.isfinite(T).all())}")
    if not np.all(np.isfinite(ev)) or tuple(T2.shape) != (n, k):
        raise AssertionError("explained variance not finite, or warm scores misshapen")
    warm_vs_cold = float((T2 - T).abs().max() / T.abs().max())

    emit(
        "main_path", engine_requested="auto", engine=type(eng).__name__,
        col_tile=eng.meta[2],
        gram_tier="int8" if eng.meta[4] else ("bf16" if eng.meta[3] else "f32"),
        buckets=[list(b) for b in eng.bwidths], cold_fit_transform_s=cold_s,
        warm_fit_transform_s=warm_s, warm_vs_cold_rel=warm_vs_cold,
        fit_timings_cold=pca._fit_timings, engine_build_s=eng.build_seconds,
        peak_alloc_gb=peak / 1e9,
        densify_launches=launches, densify_launches_by_wt=by_wt, T_shape=list(T.shape),
    )

    phase_breakdown(torch, eng, pca, k)
    phase_idle(torch, eng, builder, m)
    launches += timed("tracing", phase_tracing, torch, m, builder)

    # what the mesh phase holds its Gram fit to: these EVs and score rows
    single = dict(ev=ev, T_head=T[:MESH_SCORE_ROWS].clone())
    del T, T2, pca, pca2, eng
    m._operator_cache.clear()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    # the uncentered truth too, from the same Gram: the mesh phase's
    # Lanczos fit on these counts is held to it
    ev_raw, ev_true, iters = f64_truth_ev(torch, X, k, uncentered=True)
    truth_s = time.perf_counter() - t0
    ev_rel_err = float(np.abs(ev - ev_true).max() / ev_true[0])
    emit(
        "ev", ev_rel_err=ev_rel_err, ev_target=EV_TARGET, ev_fail_above=EV_FAIL,
        meets_target=ev_rel_err <= EV_TARGET, truth_s=truth_s,
        truth_subspace_iters=iters[1], uncentered_truth_subspace_iters=iters[0],
        ev_top3=ev[:3].tolist(), ev_true_top3=ev_true[:3].tolist(),
    )
    if not ev_rel_err <= EV_FAIL:
        raise AssertionError(f"EV rel err {ev_rel_err} > {EV_FAIL}")
    single.update(ev_raw=ev_raw)
    return launches, library_densify_ms(torch, X), X, ev_true, single


def _ev_rel_err(ev, ev_true) -> float:
    import numpy as np

    return float(np.abs(np.asarray(ev, np.float64) - ev_true).max() / ev_true[0])


def phase_dense_products(torch, op) -> None:
    """Warm CUDA-event times of the densified engine's products at 1, 8
    and 50 operand columns, their error against a float64 product of the
    first 8,192 rows, and one raw cuBLAS call on the unpadded 3-column
    stacked operand of a single-column precise product (the wrapper pads
    it to 8 columns)."""

    from single_algebra_tpu_torch.linalg.operators import bf16_terms

    n, p = op.shape
    gen = torch.Generator(device=op.device)
    gen.manual_seed(8)
    for k in (1, 8, 50):
        B = torch.randn((p, k), generator=gen, device=op.device)
        C = torch.randn((n, k), generator=gen, device=op.device)
        times = {name: _time_ms(torch, lambda f=getattr(op, name), a=arg: f(a), 3)
                 for name, arg in (("mv", B), ("rmv", C), ("mv_precise", B), ("rmv_precise", C))}
        ref = op.hi[:8192].double() @ B.double()
        if op.lo is not None:
            ref += op.lo[:8192].double() @ B.double()
        scale = float(ref.abs().max())
        line = dict(k=k, ms=times,
                    mv_rel_err=float((op.mv(B)[:8192].double() - ref).abs().max()) / scale,
                    mv_precise_rel_err=float(
                        (op.mv_precise(B)[:8192].double() - ref).abs().max()) / scale)
        if k == 50:
            # rmv over every row against float64 row blocks, beside the
            # same precise product as one cuBLAS call over all the rows;
            # a nonnegative operand (NMF's): no cancellation hides the
            # accumulation's error
            C = torch.rand((n, k), generator=gen, device=op.device)
            ref_t = torch.zeros((p, k), dtype=torch.float64, device=op.device)
            for r0 in range(0, n, 8192):
                ref_t += op.hi[r0:r0 + 8192].double().T @ C[r0:r0 + 8192].double()
                if op.lo is not None:
                    ref_t += op.lo[r0:r0 + 8192].double().T @ C[r0:r0 + 8192].double()
            stacked = torch.cat(bf16_terms(C.float()), dim=1)
            parts = torch.mm(op.hi.T, stacked, out_dtype=torch.float32).double()
            if op.lo is not None:
                parts += torch.mm(op.lo.T, stacked, out_dtype=torch.float32).double()
            one_call = parts[:, :k] + parts[:, k:2 * k] + parts[:, 2 * k:]
            scale_t = float(ref_t.abs().max())
            line.update(rmv_precise_rel_err=float(
                (op.rmv_precise(C).double() - ref_t).abs().max()) / scale_t,
                rmv_precise_one_call_rel_err=float((one_call - ref_t).abs().max()) / scale_t)
            del ref_t, stacked, parts, one_call
        if k == 1:
            stacked = torch.cat(bf16_terms(B), dim=1)  # [p, 3]
            line["mv_precise_unpadded_3col_ms"] = _time_ms(
                torch, lambda: torch.mm(op.hi, stacked, out_dtype=torch.float32), 3)
        emit("dense_products", **line)
        if not line["mv_precise_rel_err"] <= 1e-6:
            raise AssertionError(f"dense mv_precise rel err {line['mv_precise_rel_err']} > 1e-6")


def phase_dense_path(torch, data=None) -> int:
    """The densified engine's path once, through the user-facing entry
    points, at 400,000 x 30,000: 'auto' must build ``DensifiedOperator``.
    (a) ``SparsePCABuilder``'s defaults (Lanczos, adaptive, tolerance 1e-6), cold
    and warm; (c) ``lanczos_block(8)``; both construction routes give one
    payload; (b) ``SVDMethod.random(10, 7, QR)`` cold (a fresh matrix) and
    warm. Lanczos solves the RAW matrix, so (a) and (c) are held to the
    float64 truth of the uncentered Gram, failing above 1e-5. (b) is an
    A-space sketch at q = 7, which does not resolve the planted tail to
    that bar in any arithmetic: as on the tiled path it is held to a
    float64 run of the same algorithm with the same sketch (1e-4), and its
    error against the centered truth to a loose regression bar (5e-3).
    Then the non-bf16-exact variant (the counts times 1.2345, 200,000 rows): the engine must keep its lo half and
    meet the same bar."""

    import numpy as np
    import scipy.sparse as sp

    from single_algebra_tpu_torch import SparseMatrix, SparsePCABuilder
    from single_algebra_tpu_torch.linalg.operators import CenteredOperator, DensifiedOperator
    from single_algebra_tpu_torch.linalg.svd import gaussian_sketch, randomized_svd
    from single_algebra_tpu_torch.models.pca import _host_col_stats
    from single_algebra_tpu_torch.types import PowerIterationNormalizer, SVDMethod

    n, p, k = DENSE_CELLS, DENSE_GENES, K
    X, gen_s, gen_wait_s = (data or CountsWorker()).get(n, p)

    def fit(make, m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pca = make.build()
        T = pca.fit_transform(m)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if tuple(T.shape) != (m.shape[0], k) or not bool(torch.isfinite(T).all()):
            raise AssertionError(f"scores: shape {tuple(T.shape)}, not finite or misshapen")
        return pca, T, seconds

    def default():
        return SparsePCABuilder().n_components(k)

    def randomized():
        return default().svd_method(SVDMethod.random(10, 7, PowerIterationNormalizer.QR))

    t0 = time.perf_counter()
    m = SparseMatrix.from_scipy(X, device="cuda")
    from_scipy_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    pca_a, T_a, cold_a = fit(default(), m)
    peak = torch.cuda.max_memory_allocated()
    op = m._operator_cache.get("auto")
    if not isinstance(op, DensifiedOperator):
        raise AssertionError(f"engine 'auto' built {type(op).__name__}, not DensifiedOperator")
    pca_a2, T_a2, warm_a = fit(default(), m)
    warm_vs_cold = float((T_a2 - T_a).abs().max() / T_a.abs().max())
    del T_a, T_a2
    pca_c, _, warm_c = fit(default().lanczos_block(8), m)
    emit("dense_path", engine_requested="auto", engine=type(op).__name__, n=n, p=p, nnz=m.nnz,
         gen_s=gen_s, gen_wait_s=gen_wait_s, from_scipy_s=from_scipy_s,
         lo_present=op.lo is not None,
         payload_gb=op.hi.numel() * 2 / 1e9, engine_build_s=op.build_seconds,
         default_builder=dict(cold_fit_transform_s=cold_a, warm_fit_transform_s=warm_a,
                              lanczos_steps=pca_a.lanczos_steps_taken_,
                              fit_timings_cold=pca_a._fit_timings, warm_vs_cold_rel=warm_vs_cold),
         lanczos_block_8=dict(warm_fit_transform_s=warm_c, block_steps=pca_c.lanczos_steps_taken_),
         peak_alloc_gb=peak / 1e9)
    phase_dense_products(torch, op)
    emit("dense_idle", default_builder_warm=device_idle(
        torch, lambda: default().build().fit_transform(m), top=6))

    # the other construction route: host densify + upload of the dense half
    host = DensifiedOperator.from_matrix(m, device=False)
    same = bool(torch.equal(host.hi.view(torch.int16), op.hi.view(torch.int16)))
    emit("dense_routes", device_route_s=op.build_seconds, host_route_s=host.build_seconds,
         hi_identical=same, lo=[op.lo is None, host.lo is None])
    if not same or host.lo is not None or op.lo is not None:
        raise AssertionError("the two construction routes disagree on an exact matrix")
    del host
    nmf_launches = timed("nmf", phase_nmf, torch, m, X)
    del op, m
    torch.cuda.empty_cache()
    mesh_dense = timed("mesh_dense", phase_mesh_dense, torch, X)

    # (b) the randomized method, cold on a fresh matrix, then warm
    m = SparseMatrix.from_scipy(X, device="cuda")
    pca_b, _, cold_b = fit(randomized(), m)
    _, _, warm_b = fit(randomized(), m)
    mu = torch.from_numpy(_host_col_stats(m)[0] / n).to("cuda")
    del m
    torch.cuda.empty_cache()

    # (b)'s bar: the same randomized algorithm, the same sketch, float64 products
    t0 = time.perf_counter()
    omega = gaussian_sketch(p, k + 10, 42, dtype=torch.float32, device="cuda").double()
    res = randomized_svd(CenteredOperator(Csr64Operator(torch, X, "cuda"), mu), k, 10, 7,
                         PowerIterationNormalizer.QR, omega=omega)
    ev_same = (res.s.double() ** 2 / (n - 1)).cpu().numpy()
    same_s = time.perf_counter() - t0
    del res, omega, mu
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ev_raw, ev_centered, iters = f64_truth_ev(torch, X, k, uncentered=True)
    truth_s = time.perf_counter() - t0
    errs = dict(default_builder=_ev_rel_err(pca_a.explained_variance_, ev_raw),
                lanczos_block_8=_ev_rel_err(pca_c.explained_variance_, ev_raw))
    same_err = _ev_rel_err(pca_b.explained_variance_, ev_same)
    truth_err_b = _ev_rel_err(pca_b.explained_variance_, ev_centered)
    emit("dense_ev", ev_rel_err_f64_truth_uncentered=errs, ev_target=EV_TARGET,
         ev_fail_above=EV_FAIL,
         truth="dense float64 Gram (raw for Lanczos, centered for randomized) + float64 "
               "subspace iteration", truth_s=truth_s, truth_subspace_iters=list(iters),
         randomized=dict(cold_fit_transform_s=cold_b, warm_fit_transform_s=warm_b,
                         ev_rel_err_same_sketch_f64=same_err, fail_above=TILED_EV_FAIL,
                         same_sketch_f64_s=same_s,
                         ev_rel_err_f64_truth_centered=truth_err_b,
                         truth_fail_above=RANDOMIZED_TRUTH_FAIL),
         ev_top3=np.asarray(pca_a.explained_variance_)[:3].tolist(),
         ev_raw_true_top3=ev_raw[:3].tolist(), ev_centered_true_top3=ev_centered[:3].tolist())
    mesh_err = _ev_rel_err(mesh_dense.pop("ev"), ev_raw)
    emit("mesh", case="dense", n=n, p=p, entries=MESH_ENTRIES, engine="ShardedDensified",
         method="the builder's defaults (Lanczos, tolerance 1e-6)", **mesh_dense,
         single_card_warm_s=warm_a, single_card_steps=pca_a.lanczos_steps_taken_,
         ev_rel_err_f64_truth_uncentered=mesh_err, fail_above=EV_FAIL, card=card())
    if not (mesh_dense["scores_ok"] and mesh_err <= EV_FAIL):
        raise AssertionError(f"mesh dense Lanczos EV rel err {mesh_err} > {EV_FAIL}")
    if not max(errs.values()) <= EV_FAIL:
        raise AssertionError(f"dense path Lanczos EV rel err {errs} > {EV_FAIL}")
    if not same_err <= TILED_EV_FAIL:
        raise AssertionError(f"dense path randomized EV rel err vs the same-sketch f64 run "
                             f"{same_err} > {TILED_EV_FAIL}")
    if not truth_err_b <= RANDOMIZED_TRUTH_FAIL:
        raise AssertionError(f"dense path randomized EV rel err vs the centered f64 truth "
                             f"{truth_err_b} > {RANDOMIZED_TRUTH_FAIL}")

    # the non-bf16-exact variant: the same counts times a float32 constant
    n2 = DENSE_LO_CELLS
    X2 = X[:n2].tocsr()
    # the same rows with their exact counts: the steps the lo variant's are read against
    m = SparseMatrix.from_scipy(X2, device="cuda")
    steps_exact = fit(default(), m)[0].lanczos_steps_taken_
    del m
    torch.cuda.empty_cache()
    X2 = sp.csr_matrix((X2.data.astype(np.float32) * np.float32(1.2345), X2.indices, X2.indptr),
                       shape=X2.shape)
    del X
    m = SparseMatrix.from_scipy(X2, device="cuda")
    pca, _, cold_s = fit(default(), m)
    op = m._operator_cache.get("auto")
    if not isinstance(op, DensifiedOperator) or op.lo is None or not bool((op.lo != 0).any()):
        raise AssertionError("the non-bf16-exact matrix must run on DensifiedOperator with a "
                             "non-zero lo half")
    host = DensifiedOperator.from_matrix(m, device=False)
    same = bool(torch.equal(host.hi.view(torch.int16), op.hi.view(torch.int16))
                and torch.equal(host.lo.view(torch.int16), op.lo.view(torch.int16)))
    build_s, host_build_s = op.build_seconds, host.build_seconds
    del host, op, m
    torch.cuda.empty_cache()
    ev_raw2, _, _ = f64_truth_ev(torch, X2, k, uncentered=True)
    err = _ev_rel_err(pca.explained_variance_, ev_raw2)
    emit("dense_lo", n=n2, p=p, values="counts x float32(1.2345)", lo_present=True,
         routes_identical=same, engine_build_s=build_s, host_route_s=host_build_s,
         cold_fit_transform_s=cold_s, lanczos_steps=pca.lanczos_steps_taken_,
         lanczos_steps_exact_counts_same_rows=steps_exact,
         ev_rel_err=err, ev_fail_above=EV_FAIL)
    if not same or not err <= EV_FAIL:
        raise AssertionError(f"dense lo variant: routes identical={same}, EV rel err {err}")
    return nmf_launches


def csr_on_card(torch, M, dtype):
    """A scipy matrix as a ``torch.sparse_csr_tensor`` of ``dtype`` on the card."""

    import numpy as np

    M = M.tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr.astype(np.int64)), torch.from_numpy(M.indices.astype(np.int64)),
        torch.from_numpy(M.data), size=M.shape,
    ).to(device=DEVICE, dtype=dtype)


def library_densify_ms(torch, X, slab: int = 8192) -> float:
    """The densify kernel's yardstick: ``.to_dense()`` of the float32 CSR of
    one 8,192-row slab of the north-star matrix (CUDA events)."""

    A = csr_on_card(torch, X[:slab].tocsr(), torch.float32)
    ms = _time_ms(torch, lambda: A.to_dense(), 10)
    emit("library", kernel="tiled_ell_densify_t", call="float32 CSR [8192, p].to_dense()",
         shape=list(A.shape), ms=ms)
    # the bf16 slab's yardstick: the slab densified to bf16 (a bf16 CSR's
    # own to_dense where torch takes it, else the float32 one, cast)
    Ab = A.to(torch.bfloat16)
    try:
        bf16_ms, call = _time_ms(torch, lambda: Ab.to_dense(), 10), "bfloat16 CSR .to_dense()"
    except (RuntimeError, NotImplementedError):
        bf16_ms = _time_ms(torch, lambda: A.to_dense().to(torch.bfloat16), 10)
        call = "float32 CSR .to_dense().to(bfloat16)"
    emit("library", kernel="tiled_ell_densify_t", out_dtype="bfloat16", call=call, ms=bf16_ms)
    return ms


def library_tiled_ms(torch, X, kp: int = 64) -> dict:
    """The tiled kernels' yardsticks, one PyTorch call each on the tiled
    path's matrix (CUDA events): ``X @ B`` with X a float32
    ``torch.sparse_csr_tensor`` and B [p, kp], and ``X^T @ C`` with the CSR
    of X^T built beforehand and C [n, kp]; bf16 too where torch's CUDA CSR
    product takes it, and the float32 products at kp 8 (the Lanczos
    solvers' shape). -> {kernel: float32 ms at kp}."""

    n, p = X.shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    out = {}
    for name, M, width in (("tiled_ell_spmm_t", X.tocsr(), p),
                           ("tiled_ell_rmv_t", X.T.tocsr(), n)):
        for dtype in (torch.float32, torch.bfloat16):
            A = csr_on_card(torch, M, dtype)
            D = torch.randn((width, kp), generator=gen, device="cuda").to(dtype)
            try:
                ms, err = _time_ms(torch, lambda: A @ D, 3), None
            except (RuntimeError, NotImplementedError) as e:  # dtype support, reported
                ms, err = None, str(e).splitlines()[0][:200]
            emit("library", kernel=name, call=f"{str(dtype).split('.')[-1]} CSR {list(A.shape)} @ "
                 f"dense {list(D.shape)}", ms=ms, refused=err)
            if dtype == torch.float32:
                out[name] = ms
                D8 = D[:, :8].contiguous()
                emit("library", kernel=name, call=f"float32 CSR {list(A.shape)} @ dense "
                     f"{list(D8.shape)}", kp=8, ms=_time_ms(torch, lambda: A @ D8, 3))
                del D8
            del A, D
            torch.cuda.empty_cache()
    return out

def _tiled_payload(torch, gen, R, ntiles, wt, ct, *, dtype, frac, dup=False, pad_rows=0):
    """A random transposed tiled payload on the card: per (tile, row) group
    a Poisson(2.5) number of stored slots (padding trails, as the host
    converter lays it out), values 1..8 (plus a fraction for float32
    payloads), and optionally few distinct ids per group (duplicates) or
    a leading block of all-padding rows."""

    dev = torch.device("cuda")
    sizes = torch.poisson(torch.full((ntiles, 1, R), 2.5, device=dev), generator=gen)
    slot = torch.arange(wt, device=dev).view(1, wt, 1)
    real = (slot < sizes).reshape(ntiles * wt, R)
    if pad_rows:
        real[:, :pad_rows] = False
    vals = torch.randint(1, 9, (ntiles * wt, R), generator=gen, device=dev).float()
    if frac:
        vals += torch.rand(vals.shape, generator=gen, device=dev)
    ids = torch.randint(0, 4 if dup else ct, (ntiles * wt, R), generator=gen, device=dev)
    vals = (vals * real).to(dtype).contiguous()
    ids = (ids * real).int().contiguous()
    return vals, ids


def _compare_tiled(torch, result, gen, case, vals, ids, *, wt, ntiles, ct, kp, odt,
                   pad=0, rmv=True, spmm=True) -> None:
    """Both tiled kernels (spmm alone where ``rmv`` is false, rmv alone where
    ``spmm`` is) against their
    plain versions on one payload with a random operand of dtype ``odt``:
    emits a ``kernel_spmm`` and a ``kernel_rmv`` line, fails above
    KERNEL_REL_FAIL or where a repeated launch differs, and folds the
    worst abs error into ``result``. The plain version's time is that of
    the comparison call itself (CUDA events; it runs once)."""

    from single_algebra_tpu_torch.ops.spmm_kernel import (
        tiled_ell_rmv_t, tiled_ell_rmv_t_plain, tiled_ell_spmm_t, tiled_ell_spmm_t_plain,
    )

    R = vals.shape[1]
    kw = dict(wt=wt, ntiles=ntiles, col_tile=ct)
    for phase, fn, plain, width in (
        ("kernel_spmm", tiled_ell_spmm_t, tiled_ell_spmm_t_plain, ntiles * ct),
        ("kernel_rmv", tiled_ell_rmv_t, tiled_ell_rmv_t_plain, R),
    )[0 if spmm else 1:2 if rmv else 1]:
        op = torch.randn((kp, width), generator=gen, device=vals.device).to(odt)
        got = fn(vals, ids, op, **kw)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(vals, ids, op, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        del want
        repeat_equal = bool(torch.equal(fn(vals, ids, op, **kw), got))
        pad_zero = bool(not got[:, :pad].any()) if pad and phase == "kernel_spmm" else None
        del got
        ms = _time_ms(torch, lambda: fn(vals, ids, op, **kw), 10)
        emit(phase, case=case, wt=wt, payload=str(vals.dtype).split(".")[-1],
             operand=str(odt).split(".")[-1], R=R, ntiles=ntiles, col_tile=ct, kp=kp,
             rel_err=rel, max_abs_err=abs_err, repeat_equal=repeat_equal,
             pad_block_zero=pad_zero, ms=ms, plain_ms=plain_ms)
        if not rel <= KERNEL_REL_FAIL or pad_zero is False or not repeat_equal:
            raise AssertionError(f"{phase} {case}: kernel vs plain rel err {rel}, "
                                 f"repeat_equal={repeat_equal}, pad_block_zero={pad_zero}")
        name = "tiled_ell_spmm_t" if phase == "kernel_spmm" else "tiled_ell_rmv_t"
        entry = result.setdefault(name, dict(max_abs_err=0.0))
        entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
        entry.setdefault("cases", {})[case] = dict(ms=ms, plain_ms=plain_ms)
        del op
        torch.cuda.empty_cache()


def phase_kernel_tiled(torch, result: dict) -> None:
    """spmm and rmv kernels vs their plain versions on random payloads of
    the tiled path's tile geometry at R 16,384: the dtype cases, duplicate
    ids and an all-padding row block (the path's own payload is compared
    at its full 500,736 rows in ``tiled_path``)."""

    dev = torch.device("cuda")
    R, ntiles, ct, kp = 16384, 237, 256, 64
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (  # name, wt, payload, operand, dup ids, all-padding rows
        ("bf16_x_bf16", 16, bf16, bf16, False, 0),
        ("bf16_x_f32", 16, bf16, f32, False, 0),
        ("f32_x_f32_wt24", 24, f32, f32, False, 0),
        ("dup_ids", 16, bf16, bf16, True, 0),
        ("pad_block", 16, bf16, f32, False, 4096),
    )
    for case, wt, pdt, odt, dup, pad in cases:
        vals, ids = _tiled_payload(torch, gen, R, ntiles, wt, ct, dtype=pdt,
                                   frac=pdt == f32, dup=dup, pad_rows=pad)
        _compare_tiled(torch, result, gen, case, vals, ids, wt=wt, ntiles=ntiles, ct=ct,
                       kp=kp, odt=odt, pad=pad)
        del vals, ids
        torch.cuda.empty_cache()


def phase_kernel_tiled_path(torch, op, result: dict) -> None:
    """spmm and rmv kernels vs their plain versions on the tiled engine's
    own payload, at the shapes the path gives them (all its rows): at kp 64
    the bf16 operand of the power iterations and the float32 operand of
    the precise products, spmm at the projection's kp 56 with a float32
    operand (the one shape whose kp is not a multiple of the kernel's
    output chunk), and both at kp 8 with a float32 operand (the Lanczos
    recurrence's single column, and ``lanczos_block(8)``'s block). The kp
    64 bf16 case gives the kernels line its times."""

    wt, ntiles, ct = op.meta[:3]
    gen = torch.Generator(device=op.device)
    gen.manual_seed(4)
    for case, odt, kp, rmv in (("path_bf16_x_bf16", torch.bfloat16, 64, True),
                               ("path_bf16_x_f32", torch.float32, 64, True),
                               ("path_bf16_x_f32_kp56", torch.float32, 56, False),
                               ("path_bf16_x_f32_kp8", torch.float32, 8, True)):
        _compare_tiled(torch, result, gen, case, op.tdata, op.tlocal, wt=wt, ntiles=ntiles,
                       ct=ct, kp=kp, odt=odt, rmv=rmv)
    for entry in result.values():
        entry.update(entry["cases"]["path_bf16_x_bf16"])
    # bounds of the bf16 x bf16 case at kp 64: each input read once, each
    # output written once; one multiply-add per stored slot and output column
    R, kp = op.tdata.shape[1], 64
    payload = op.tdata.numel() * op.tdata.element_size() + op.tlocal.numel() * 4
    stored = int((op.tdata != 0).sum())
    flops = 2.0 * stored * kp
    result["tiled_ell_spmm_t"].update(bound(payload + kp * ntiles * ct * 2 + kp * R * 4, flops))
    result["tiled_ell_rmv_t"].update(bound(payload + kp * R * 2 + ntiles * ct * kp * 4, flops))
    kp8 = {name: bound(payload + 8 * ntiles * ct * 4 + 8 * R * 4, 2.0 * stored * 8)["bound_ms"]
           for name in ("spmm", "rmv")}  # float32 operand in, float32 result out
    emit("tiled_bounds", stored=stored, slots=op.tdata.numel(), payload_bytes=payload,
         spmm=result["tiled_ell_spmm_t"]["bound_ms"], rmv=result["tiled_ell_rmv_t"]["bound_ms"],
         spmm_f32_kp8=kp8["spmm"], rmv_f32_kp8=kp8["rmv"])


class Csr64Operator:
    """``A`` in float64 on the card as two ``torch.sparse_csr_tensor``s (the
    matrix and its transpose): an operator independent of the port's
    payloads and kernels, whose products are exact to float64."""

    def __init__(self, torch, X, device, Xt=None):
        import numpy as np

        def csr(M):
            return torch.sparse_csr_tensor(
                torch.from_numpy(M.indptr.astype(np.int64)),
                torch.from_numpy(M.indices.astype(np.int64)),
                torch.from_numpy(M.data.astype(np.float64)), size=M.shape,
            ).to(device)

        self.shape = X.shape
        self.dtype = torch.float64
        self.device = torch.device(device)
        self.a = csr(X.tocsr())
        self.at = csr(X.tocsc().T.tocsr() if Xt is None else Xt)

    def mv(self, B):
        return self.a @ B

    def rmv(self, C):
        return self.at @ C


def phase_tiled_path(torch, kernel_result: dict, data=None) -> dict:
    """The tiled engine's path once, through the user-facing entry points;
    -> the kernels' launch counts in the cold fit and ``lsi``'s, and in the
    mesh tiled fits on the same matrix. The full-size kernel comparisons on the
    engine's payload and on a mesh slab's add to ``kernel_result``."""

    import numpy as np

    from single_algebra_tpu_torch import SparseMatrix, SparsePCABuilder
    from single_algebra_tpu_torch.linalg.operators import CenteredOperator, TiledSparseOperator
    from single_algebra_tpu_torch.linalg.svd import gaussian_sketch, randomized_svd
    from single_algebra_tpu_torch.models.pca import _host_col_stats
    from single_algebra_tpu_torch.ops import cuda_lib
    from single_algebra_tpu_torch.ops.spmm import ell_spmm
    from single_algebra_tpu_torch.sparse import convert as cv
    from single_algebra_tpu_torch.types import PowerIterationNormalizer, SVDMethod

    n, p, k = TILED_CELLS, TILED_GENES, K
    X, gen_s, gen_wait_s = (data or CountsWorker()).get(n, p)
    t0 = time.perf_counter()
    m = SparseMatrix.from_scipy(X, device="cuda")
    from_scipy_s = time.perf_counter() - t0

    def builder():
        return (SparsePCABuilder().n_components(k)
                .svd_method(SVDMethod.random(10, 7, PowerIterationNormalizer.QR)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    pca = builder().build()
    T = pca.fit_transform(m)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = {name: cuda_lib.launch_counts[name]
                for name in ("tiled_ell_spmm_t", "tiled_ell_rmv_t")}
    peak = torch.cuda.max_memory_allocated()
    op = m._operator_cache.get("auto")
    ev = np.asarray(pca.explained_variance_, np.float64)

    t0 = time.perf_counter()
    T2 = builder().build().fit_transform(m)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    if not isinstance(op, TiledSparseOperator):
        raise AssertionError(f"engine 'auto' built {type(op).__name__}, not TiledSparseOperator")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the tiled path did not launch both kernels: {launches}")
    if tuple(T.shape) != (n, k) or not bool(torch.isfinite(T).all()):
        raise AssertionError(f"scores: shape {tuple(T.shape)}, finite={bool(torch.isfinite(T).all())}")
    if not np.all(np.isfinite(ev)) or tuple(T2.shape) != (n, k):
        raise AssertionError("explained variance not finite, or warm scores misshapen")
    warm_vs_cold = float((T2 - T).abs().max() / T.abs().max())
    del T2

    # the host passes of the engine choice and the payload build, alone
    src = m._layout_for("row")
    t0 = time.perf_counter()
    wt, ntiles, ovw, n_over = cv.tiled_split_widths(src._h_indptr, src._h_indices, n, p)
    widths_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ovtw_plan = cv.tiled_overflow_col_width(src._h_indptr, src._h_indices, n, p, 256, wt)
    overflow_col_width_s = time.perf_counter() - t0
    wt, nt, ct, br, ovw, ovtw = op.meta
    emit(
        "tiled_path", engine_requested="auto", engine=type(op).__name__, n=n, p=p,
        nnz=m.nnz, gen_s=gen_s, gen_wait_s=gen_wait_s, from_scipy_s=from_scipy_s, wt=wt,
        ntiles=nt, col_tile=ct,
        rows_padded=op.tdata.shape[1], ovw=ovw, ovtw=ovtw, ovtw_plan=ovtw_plan,
        n_overflow=n_over, payload="bf16" if op._bf16 else str(op.tdata.dtype).split(".")[-1],
        lo_present=op.tdata_lo is not None, payload_bytes_f32_accounting=(
            (nt * wt + ovw) * op.tdata.shape[1] * 8
            + (cv.pad_rows(p) * cv.round_up(max(ovtw_plan, 1), 8) * 8 if ovw else 0)),
        payload_bytes_on_card=sum(
            t.numel() * t.element_size() for t in (op.tdata, op.tdata_lo, op.tlocal, op.ov_data,
                                                   op.ov_ids, op.ovt_data, op.ovt_ids)
            if t is not None),
        cold_fit_transform_s=cold_s, warm_fit_transform_s=warm_s,
        warm_vs_cold_rel=warm_vs_cold, fit_timings_cold=pca._fit_timings,
        engine_build_s=op.build_seconds, split_widths_s=widths_s,
        overflow_col_width_s=overflow_col_width_s, peak_alloc_gb=peak / 1e9,
        launches=launches, T_shape=list(T.shape),
    )
    del T

    phase_tiled_breakdown(torch, op, ell_spmm)
    emit("tiled_idle", warm_fit_transform=device_idle(
        torch, lambda: builder().build().fit_transform(m), top=8))
    lanczos = phase_tiled_lanczos(torch, m, k)
    phase_masked_tiled(torch, m, X)
    phase_kernel_tiled_path(torch, op, kernel_result)
    for name, ms in library_tiled_ms(torch, X).items():
        kernel_result[name]["library_ms"] = ms
    del op, src
    m._operator_cache.clear()  # the single-card engine goes before the mesh builds its own
    torch.cuda.empty_cache()
    mesh_launches = timed("mesh_tiled", phase_mesh_tiled, torch, m, ev, lanczos, kernel_result)

    # EV bar: the same randomized algorithm, the same sketch, float64 products
    l = k + 10
    omega = gaussian_sketch(p, l, 42, dtype=torch.float32, device=m.device).double()
    col_sums, _ = _host_col_stats(m)
    mu = torch.from_numpy(col_sums / n).to(m.device)
    del m
    torch.cuda.empty_cache()
    lsi_run = timed("lsi", phase_lsi, torch, X, kernel_result)
    launches = {k: launches[k] + lsi_run["launches"][k] for k in launches}
    t0 = time.perf_counter()
    ref_op = CenteredOperator(Csr64Operator(torch, X, "cuda"), mu)
    res = randomized_svd(ref_op, k, 10, 7, PowerIterationNormalizer.QR, omega=omega)
    ev_same = (res.s.double() ** 2 / (n - 1)).cpu().numpy()
    same_s = time.perf_counter() - t0
    del res, omega
    torch.cuda.empty_cache()
    same_err = float(np.abs(ev - ev_same).max() / ev_same[0])
    twins = tiled_lanczos_f64_twins(torch, ref_op.base, lanczos, k)
    lsi_f64(torch, ref_op.base, X, lsi_run)
    del ref_op, lsi_run
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ev_raw_true, ev_true, iters = f64_truth_ev(torch, X, k, uncentered=True)
    iters = iters[1]
    truth_s = time.perf_counter() - t0
    worst = worst_truth = 0.0
    for name, run in lanczos.items():
        same = _ev_rel_err(run["ev"], twins[name]["ev"])
        vs_truth = _ev_rel_err(run["ev"], ev_raw_true)
        worst, worst_truth = max(worst, same), max(worst_truth, vs_truth)
        emit("tiled_lanczos", method=name, engine="TiledSparseOperator", n=n, p=p,
             warm_fit_transform_s=run["seconds"], steps=run["steps"], launches=run["launches"],
             ev_rel_err_same_start_f64=same, fail_above=TILED_EV_FAIL,
             same_start_f64_s=twins[name]["seconds"],
             ev_rel_err_f64_truth_uncentered=vs_truth, truth_fail_above=EV_FAIL,
             ev_top3=run["ev"][:3].tolist(), ev_raw_true_top3=ev_raw_true[:3].tolist())
    if not worst <= TILED_EV_FAIL:
        raise AssertionError(f"tiled Lanczos EV rel err vs the same-start f64 run {worst} "
                             f"> {TILED_EV_FAIL}")
    if not worst_truth <= EV_FAIL:
        raise AssertionError(f"tiled Lanczos EV rel err vs the uncentered f64 truth "
                             f"{worst_truth} > {EV_FAIL}")
    truth_err = float(np.abs(ev - ev_true).max() / ev_true[0])
    emit(
        "tiled_ev", ev_rel_err_same_sketch_f64=same_err, fail_above=TILED_EV_FAIL,
        same_sketch_f64_s=same_s, ev_rel_err_f64_truth=truth_err,
        truth="dense float64 Gram + float64 subspace iteration", truth_s=truth_s,
        truth_subspace_iters=iters, ev_top3=ev[:3].tolist(),
        ev_same_sketch_top3=ev_same[:3].tolist(), ev_true_top3=ev_true[:3].tolist(),
        ev_tail=[ev[-1], ev_same[-1], ev_true[-1]],
        host_peak_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
    )
    if not same_err <= TILED_EV_FAIL:
        raise AssertionError(f"tiled EV rel err vs the same-sketch f64 run {same_err} > {TILED_EV_FAIL}")
    return launches, mesh_launches


def phase_tiled_lanczos(torch, m, k: int) -> dict:
    """``SparsePCABuilder``'s defaults (scalar Lanczos, adaptive, tolerance 1e-6)
    and ``lanczos_block(8)`` on the tiled path's matrix and cached engine:
    seconds, steps, kernel launches, explained variances. Both run whole
    (to convergence)."""

    import numpy as np

    from single_algebra_tpu_torch import SparsePCABuilder
    from single_algebra_tpu_torch.ops import cuda_lib

    runs = {}
    for name, block in (("default_builder", None), ("lanczos_block_8", 8)):
        cuda_lib.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pca = SparsePCABuilder().n_components(k).lanczos_block(block).build()
        T = pca.fit_transform(m)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {kn: cuda_lib.launch_counts[kn] for kn in ("tiled_ell_spmm_t", "tiled_ell_rmv_t")}
        if tuple(T.shape) != (m.shape[0], k) or not bool(torch.isfinite(T).all()):
            raise AssertionError(f"tiled Lanczos ({name}) scores: shape {tuple(T.shape)}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"tiled Lanczos ({name}) did not launch both kernels: {launches}")
        runs[name] = dict(seconds=seconds, steps=pca.lanczos_steps_taken_, launches=launches,
                          block=block, seed=pca.random_seed,
                          ev=np.asarray(pca.explained_variance_, np.float64))
        del T
    return runs


def tiled_lanczos_f64_twins(torch, op64, runs: dict, k: int) -> dict:
    """The same recurrences in float64 over exact float64 CSR products,
    from the port's own start vector / block (the seeded float32 draw,
    widened) and for the steps each port run took -> {name: ev, seconds}."""

    from single_algebra_tpu_torch.linalg.block_lanczos import block_lanczos_svd
    from single_algebra_tpu_torch.linalg.lanczos import lanczos_svd

    n, p = op64.shape
    out = {}
    for name, run in runs.items():
        gen = torch.Generator(device=op64.device)
        gen.manual_seed(int(run["seed"]))
        t0 = time.perf_counter()
        if run["block"] is None:
            v0 = torch.randn(p, generator=gen, dtype=torch.float32, device=op64.device)
            res = lanczos_svd(op64, k, steps=run["steps"], v0=v0.double())
        else:
            V1 = torch.linalg.qr(torch.randn((p, run["block"]), generator=gen,
                                             dtype=torch.float32, device=op64.device))[0]
            res = block_lanczos_svd(op64, k, block_size=run["block"], steps=run["steps"],
                                    V1=V1.double())
        ev = (res.s.double() ** 2 / (n - 1)).cpu().numpy()
        out[name] = dict(ev=ev, seconds=time.perf_counter() - t0)
        del res
        torch.cuda.empty_cache()
    return out


def phase_tiled_breakdown(torch, op, ell_spmm) -> None:
    """Warm CUDA-event times of one product of each class at kp 64 (l = 60
    sketch columns) and of the overflow side products alone."""

    n, p = op.shape
    gen = torch.Generator(device=op.device)
    gen.manual_seed(5)
    B = torch.randn((p, K + 10), generator=gen, device=op.device)
    C = torch.randn((n, K + 10), generator=gen, device=op.device)
    times = {name: _time_ms(torch, lambda f=getattr(op, name), a=arg: f(a), 3)
             for name, arg in (("mv_fast", B), ("rmv_fast", C), ("mv", B), ("rmv", C))}
    if op.meta[4]:
        times["overflow_mv_ell_spmm"] = _time_ms(
            torch, lambda: ell_spmm(op.ov_data, op.ov_ids, B), 3)
    if op.meta[5]:
        times["overflow_rmv_ell_spmm"] = _time_ms(
            torch, lambda: ell_spmm(op.ovt_data, op.ovt_ids, C), 3)
    emit("tiled_breakdown", kp=64, ms=times)


# --------------------------------------------------------------------------
# the reference crate's preprocessing and masked-PCA pipeline
# --------------------------------------------------------------------------


def _line_truth(torch, indptr, indices, vals, n_lines: int, minor_mask):
    """float64 per-line statistics of host CSR arrays (the independent
    side of the ``stats`` bars), reduced on the card from the uploaded
    arrays (the counts are integers: every float64 sum here is exact, in
    any order): count, sum, sum of squares, min, max over the stored
    entries, and the same count / sums over the entries whose minor index
    is masked in; ``line``: each entry's line, on the card."""

    import numpy as np

    dev = torch.device(DEVICE)
    count = np.diff(indptr)
    cnt = torch.from_numpy(count).to(dev)
    line = torch.repeat_interleave(torch.arange(n_lines, device=dev), cnt)
    v = torch.from_numpy(vals).to(dev).double()
    keep = torch.from_numpy(minor_mask).to(dev)[torch.from_numpy(indices).to(dev).long()]

    def per_line(x):
        out = torch.zeros(n_lines, dtype=torch.float64, device=dev).index_add_(0, line, x)
        return out.cpu().numpy()

    kv = torch.where(keep, v, torch.zeros_like(v))
    out = dict(count=count, line=line, sum=per_line(v), sumsq=per_line(v * v),
               count_m=per_line(keep.double()).astype(np.int64), sum_m=per_line(kv),
               sumsq_m=per_line(kv * kv))
    del kv, keep
    big = float(np.finfo(np.float32).max)
    full = cnt > 0  # exact in the stored dtype: min / max pick stored values
    mins = torch.segment_reduce(v, "min", lengths=cnt, unsafe=True)
    maxs = torch.segment_reduce(v, "max", lengths=cnt, unsafe=True)
    out.update(min=torch.where(full, mins, big).cpu().numpy(),
               max=torch.where(full, maxs, -big).cpu().numpy())
    return out


def _stored_var64(count, s, sq):
    import numpy as np

    c = np.maximum(count, 1)
    return np.where(count > 0, np.maximum(sq / c - (s / c) ** 2, 0.0), 0.0)


def _bessel64(s, sq, n):
    mean = s / n
    return (sq / n - mean * mean) * n / (n - 1)


def _top_n_truth(indptr, vals, rows: int, n_top: int):
    """float64 sum of the n largest stored values of the first ``rows``
    lines (host, through a padded copy of those lines)."""

    import numpy as np

    count = np.diff(indptr[: rows + 1])
    width = int(count.max())
    pad = np.full((rows, width), -np.inf)
    line = np.repeat(np.arange(rows), count)
    pos = np.arange(int(indptr[rows])) - indptr[line]
    pad[line, pos] = vals[: int(indptr[rows])]
    if width > n_top:
        pad = -np.partition(-pad, n_top - 1, axis=1)[:, :n_top]
    return np.where(np.isfinite(pad), pad, 0.0).sum(axis=1)


def phase_stats(torch, X):
    """BASELINE config #1 on the north star's counts: both device layouts
    (host ELL build, upload: times, widths, bytes), then every statistic
    per axis timed (CUDA events) beside its bound (the ELL arrays it reads
    and its output over 3.35 TB/s) and held to float64 truths from the
    host CSR arrays: counts and min / max exactly, the others at most
    1e-6 of the largest |truth|. -> the matrix, both layouts cached."""

    import numpy as np

    from single_algebra_tpu_torch import SparseMatrix

    n, p = X.shape
    m = SparseMatrix.from_scipy(X, device=DEVICE)
    t0 = time.perf_counter()
    col = m.transpose()
    transpose_s = time.perf_counter() - t0
    layouts = {}
    for name, lay in (("row", m), ("col", col)):
        arrays = lay._device_layout()
        layouts[name] = dict(width=lay.ell_width, lines=int(arrays[0].shape[0]),
                             bytes=sum(a.numel() * a.element_size() for a in arrays),
                             build_s=lay.ell_build_seconds)
    layouts["col"]["host_transpose_s"] = transpose_s
    emit("stats_layouts", n=n, p=p, nnz=m.nnz, **layouts)

    rng = np.random.default_rng(12)
    row_mask, col_mask = rng.random(n) < 0.5, rng.random(p) < 0.5
    t0 = time.perf_counter()
    tr = _line_truth(torch, m._h_indptr, m._h_indices, m._h_data, n, col_mask)
    tc = _line_truth(torch, col._h_indptr, col._h_indices, col._h_data, p, row_mask)
    sizes = np.full(64, n // 64)
    sizes[: n % 64] += 1
    labels = np.repeat(np.arange(64), sizes)  # the generator's row clusters
    bins = tc.pop("line") * 64
    bins += torch.from_numpy(labels).to(bins.device)[
        torch.from_numpy(col._h_indices).to(bins.device).long()]
    del tr["line"]
    v = torch.from_numpy(col._h_data).to(bins.device).double()

    def per_bin(x):
        out = torch.zeros(p * 64, dtype=torch.float64, device=bins.device)
        return out.index_add_(0, bins, x).cpu().numpy().reshape(p, 64)

    bs, bsq, bc = per_bin(v), per_bin(v * v), per_bin(torch.ones_like(v))
    del bins, v
    n_top_rows = min(n, 50_000)
    top_truth = _top_n_truth(m._h_indptr, m._h_data[: m._h_indptr[n_top_rows]].astype(np.float64),
                             n_top_rows, 50)
    truth_s = time.perf_counter() - t0

    def lay_bytes(lay, *parts):
        d, i, z = lay._device_layout()
        sizes = dict(data=d.numel() * d.element_size(), ids=i.numel() * 4, nnz=z.numel() * 4)
        return sum(sizes[part] for part in parts)

    R, C = (m, n), (col, p)  # the layout of a line statistic, and its length
    batch_list = labels.tolist()
    cases = (  # name, call, truth, exact?, layout, arrays read, outputs per line
        ("nonzero_row", lambda: m.nonzero_row(), tr["count"], True, R, ("nnz",), 1),
        ("nonzero_col", lambda: m.nonzero_col(), tc["count"], True, C, ("nnz",), 1),
        ("sum_row", lambda: m.sum_row(), tr["sum"], False, R, ("data",), 1),
        ("sum_col", lambda: m.sum_col(), tc["sum"], False, C, ("data",), 1),
        ("sum_row_squared", lambda: m.sum_row_squared(), tr["sumsq"], False, R, ("data",), 1),
        ("sum_col_squared", lambda: m.sum_col_squared(), tc["sumsq"], False, C, ("data",), 1),
        ("var_row", lambda: m.var_row(), _bessel64(tr["sum"], tr["sumsq"], p), False, R,
         ("data",), 1),
        ("var_col", lambda: m.var_col(), _bessel64(tc["sum"], tc["sumsq"], n), False, C,
         ("data",), 1),
        ("min_row", lambda: m.min_max_row()[0], tr["min"], True, R, ("data", "nnz"), 2),
        ("max_row", lambda: m.min_max_row()[1], tr["max"], True, R, ("data", "nnz"), 2),
        ("min_col", lambda: m.min_max_col()[0], tc["min"], True, C, ("data", "nnz"), 2),
        ("max_col", lambda: m.min_max_col()[1], tc["max"], True, C, ("data", "nnz"), 2),
        ("nonzero_row_masked", lambda: m.nonzero_row_masked(col_mask), tr["count_m"], True, R,
         ("ids", "nnz"), 1),
        ("nonzero_col_masked", lambda: m.nonzero_col_masked(row_mask), tc["count_m"], True, C,
         ("ids", "nnz"), 1),
        ("sum_row_masked", lambda: m.sum_row_masked(col_mask), tr["sum_m"], False, R,
         ("data", "ids", "nnz"), 1),
        ("sum_col_masked", lambda: m.sum_col_masked(row_mask), tc["sum_m"], False, C,
         ("data", "ids", "nnz"), 1),
        ("var_row_masked", lambda: m.var_row_masked(col_mask),
         _stored_var64(tr["count_m"], tr["sum_m"], tr["sumsq_m"]), False, R,
         ("data", "ids", "nnz"), 1),
        ("var_col_masked", lambda: m.var_col_masked(row_mask),
         _stored_var64(tc["count_m"], tc["sum_m"], tc["sumsq_m"]), False, C,
         ("data", "ids", "nnz"), 1),
        ("mean_batch_col", lambda: m.mean_batch_col(batch_list), bs / sizes[None, :], False, C,
         ("data", "ids"), 64),
        ("var_batch_row", lambda: m.var_batch_row(batch_list),
         np.where(bc > 1, (bsq - bs * bs / np.maximum(bc, 1)) / np.maximum(bc - 1, 1), 0.0),
         False, C, ("data", "ids", "nnz"), 64),
        ("sum_row_n_top_50", lambda: m.sum_row_n_top(50),
         top_truth, False, R,
         ("data", "nnz"), 1),
    )
    failed = []
    for name, call, truth, exact, (lay, n_lines), parts, per_line in cases:
        got = call()
        torch.cuda.synchronize()
        if isinstance(got, dict):  # batch statistics: one column per batch, in label order
            got = torch.stack([got[b] for b in range(64)], dim=1)
        got = got.double().cpu().numpy()[: len(truth)]
        if exact:
            err = float(np.abs(got - truth).max())
            ok = err == 0.0
        else:
            err = float(np.abs(got - truth).max() / np.abs(truth).max())
            ok = err <= STAT_REL_FAIL
        ms = _time_ms(torch, call, 3)
        bd = bound(lay_bytes(lay, *parts) + n_lines * per_line * 4)
        emit("stats", stat=name, ms=ms, **bd, share_of_bound=bd["bound_ms"] / ms,
             exact=exact, err=err, fail_above=0.0 if exact else STAT_REL_FAIL,
             rows_checked=len(truth))
        if not ok:
            failed.append((name, err))
    emit("stats_truth", float64_s=truth_s, on="the card, from the host CSR arrays",
         n_top_rows_checked=n_top_rows,
         mask="seeded half of the rows / columns", batches="the 64 generator clusters")
    if failed:
        raise AssertionError(f"statistics off their float64 truth: {failed}")
    return m


def _top_mask(torch, values, n_keep: int):
    """Bool mask of the ``n_keep`` largest entries (a stand-in for
    highly-variable-gene selection)."""

    mask = torch.zeros(values.shape[0], dtype=torch.bool, device=values.device)
    mask[torch.topk(values, n_keep).indices] = True
    return mask


def phase_pipeline(torch, m) -> dict:
    """This slice's main path, the reference crate's pipeline, on the
    north star's counts ``m`` (both layouts cached by ``stats``):
    ``sum_row`` -> ``normalize(lib, 1e4, ROW)`` -> ``log1p_normalize`` ->
    the top 2,000 columns of ``var_col`` -> ``MaskedSparsePCABuilder``'s
    defaults (Lanczos, engine 'auto') cold and warm, then the randomized
    method on the cached engine. The engine must be ``GramPCAEngine`` on
    its float32 tier, with float32 densify slabs in its Gram pass. Bars:
    stored values against a float64 recompute (1e-6 relative, per value),
    the Lanczos EVs against the float64 UNCENTERED masked truth and the
    randomized EVs against the CENTERED masked truth (1e-5 each), both
    from one float64 Gram of the log-normalized matrix. Also
    ``log1p_ulp``. -> what the next phases reuse."""

    import numpy as np
    import scipy.sparse as sp

    from single_algebra_tpu_torch import Direction, MaskedSparsePCABuilder
    from single_algebra_tpu_torch.linalg.gram import GramPCAEngine, _slab_for, gram_matrix
    from single_algebra_tpu_torch.ops import cuda_lib
    from single_algebra_tpu_torch.types import PowerIterationNormalizer, SVDMethod

    n, p = m.shape
    k = K

    def step(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    lib, lib_s = step(lambda: m.sum_row())
    Xn, norm_s = step(lambda: m.normalize(lib, NORM_TARGET, Direction.ROW))
    Xl, log_s = step(lambda: Xn.log1p_normalize())
    mask, mask_s = step(lambda: _top_mask(torch, Xl.var_col(), HVG))
    mask_np = mask.cpu().numpy()
    phase_log1p_ulp(torch, Xn)
    del Xn, lib

    def builder():
        return MaskedSparsePCABuilder().mask(mask_np).n_components(k)

    def fit(make):
        pca = make.build()
        return pca, pca.fit_transform(Xl)

    cuda_lib.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    (pca, T), cold_s = step(lambda: fit(builder()))
    launches = dict(cuda_lib.densify_launches_by_dtype)
    peak = torch.cuda.max_memory_allocated()
    eng = Xl._operator_cache.get("auto")
    (pca_w, T_w), warm_s = step(lambda: fit(builder()))
    (pca_r, _), rand_s = step(lambda: fit(builder().svd_method(
        SVDMethod.random(10, 7, PowerIterationNormalizer.QR))))
    if not isinstance(eng, GramPCAEngine):
        raise AssertionError(f"engine 'auto' built {type(eng).__name__}, not GramPCAEngine")
    tier = "int8" if eng.meta[4] else ("bf16" if eng.meta[3] else "f32")
    slab = _slab_for(n)
    slabs = sum(rc // slab for _, rc in eng.bwidths)
    if tier != "f32" or launches != {"float32": 2 * slabs}:
        raise AssertionError(f"tier {tier}, densify launches {launches}: want f32 and "
                             f"{2 * slabs} float32 slabs (Gram pass + projection)")
    if tuple(T.shape) != (n, k) or not bool(torch.isfinite(T).all()):
        raise AssertionError(f"scores: shape {tuple(T.shape)}, not finite or misshapen")
    warm_vs_cold = float((T_w - T).abs().max() / T.abs().max())
    del T_w

    # the Gram pass alone: its densify launches by output type, and the
    # densify kernel alone over the same slabs
    cuda_lib.reset_launch_counts()
    _, gram_s = step(lambda: gram_matrix(eng))
    gram_launches = dict(cuda_lib.densify_launches_by_dtype)
    if gram_launches != {"float32": slabs}:
        raise AssertionError(f"Gram pass densify launches {gram_launches}, want {slabs} float32")
    def densify_all():
        for b, (_, rc) in enumerate(eng.bwidths):
            for i in range(rc // slab):
                eng._densify(b, i, torch.float32)  # each slab is dropped before the next

    _, densify_s = step(densify_all)
    emit("pipeline", n=n, p=p, nnz=m.nnz, hvg=HVG, engine=type(eng).__name__, gram_tier=tier,
         col_tile=eng.meta[2], buckets=[list(b) for b in eng.bwidths],
         steps_s=dict(sum_row=lib_s, normalize=norm_s, log1p_normalize=log_s,
                      var_col_top_mask=mask_s),
         cold_fit_transform_s=cold_s, warm_fit_transform_s=warm_s,
         randomized_warm_fit_transform_s=rand_s, warm_vs_cold_rel=warm_vs_cold,
         fit_timings_cold=pca._fit_timings, engine_build_s=eng.build_seconds,
         values_pull_s=Xl.pull_seconds,
         densify_launches_cold=launches, gram_pass_s=gram_s,
         gram_pass_densify_launches=gram_launches, densify_f32_all_slabs_s=densify_s,
         peak_alloc_gb=peak / 1e9, T_shape=list(T.shape))

    # bars: the stored values against a float64 recompute from the counts,
    # on the card (the row sums are exact integers in float64 in any order)
    t0 = time.perf_counter()
    vals = Xl._csr_data_host()
    dev = torch.device(DEVICE)
    c64 = torch.from_numpy(m._h_data).to(dev).double()
    row_of = torch.repeat_interleave(torch.arange(n, device=dev),
                                     torch.from_numpy(np.diff(m._h_indptr)).to(dev))
    rs = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, row_of, c64)[row_of]
    v64 = torch.log1p(torch.where(rs > 0, c64 * (NORM_TARGET / torch.where(rs > 0, rs, 1.0)),
                                  c64))
    del row_of, c64, rs
    got = torch.from_numpy(vals).to(dev).double()
    value_err = float(((got - v64).abs() / v64.abs()).max())
    del v64, got
    recompute_s = time.perf_counter() - t0
    Xl64 = sp.csr_matrix((vals.astype(np.float64), m._h_indices, m._h_indptr), shape=(n, p))
    t0 = time.perf_counter()
    gram = f64_gram(torch, Xl64, device=DEVICE)
    gram_s64 = time.perf_counter() - t0
    idx = np.where(mask_np)[0]
    ev_raw, ev_cen, iters = f64_truth_ev(torch, Xl64, k, uncentered=True, cols=idx, gram=gram)
    errs = dict(lanczos_cold=_ev_rel_err(pca.explained_variance_, ev_raw),
                lanczos_warm=_ev_rel_err(pca_w.explained_variance_, ev_raw),
                randomized=_ev_rel_err(pca_r.explained_variance_, ev_cen))
    emit("pipeline_ev", value_rel_err=value_err, value_fail_above=VALUE_REL_FAIL,
         value_recompute_s=recompute_s, ev_rel_err=errs, ev_fail_above=EV_FAIL,
         truth="float64 Gram of the log-normalized matrix: its masked submatrix, "
               "uncentered (Lanczos) and centered (randomized)", f64_gram_s=gram_s64,
         ev_top3=np.asarray(pca.explained_variance_)[:3].tolist(),
         ev_raw_true_top3=ev_raw[:3].tolist(), ev_centered_true_top3=ev_cen[:3].tolist())
    if not value_err <= VALUE_REL_FAIL:
        raise AssertionError(f"log-normalized values rel err {value_err} > {VALUE_REL_FAIL}")
    if not max(errs.values()) <= EV_FAIL:
        raise AssertionError(f"masked PCA EV rel err {errs} > {EV_FAIL}")
    # the Gram engine stays cached for the scrna phase's warm masked fit,
    # which clears it; the layouts stay for sparse_engine
    return dict(Xl=Xl, Xl64=Xl64, gram=gram, T=T)


def phase_log1p_ulp(torch, Xn) -> None:
    """``torch.log1p`` on the card over the normalized matrix's stored
    values, in ULPs of the float32 result against float64: the bound
    ``tests/test_precise_math.py`` holds the JAX package's precise log1p
    to (< 3 ULP) decides whether the port needs that module."""

    from single_algebra_tpu_torch.ops.stats import valid_mask

    d, ids, row_nnz = Xn._device_layout()
    v = d[valid_mask(ids, row_nnz)]
    y64 = torch.log1p(v.double())
    ref = y64.float().abs()
    ulp = (torch.log1p(v).double() - y64).abs() / (
        torch.nextafter(ref, torch.full_like(ref, float("inf"))) - ref).double()
    worst = float(ulp.max())
    emit("log1p_ulp", values=v.numel(), value_range=[float(v.min()), float(v.max())],
         max_ulp=worst, mean_ulp=float(ulp.mean()), fail_above=LOG1P_ULP_FAIL)
    if not worst <= LOG1P_ULP_FAIL:
        raise AssertionError(f"torch.log1p on the card: {worst} ULP > {LOG1P_ULP_FAIL}")


def phase_streaming(torch, X, ev_true, held_widths, Xl64) -> int:
    """Cell 10: single-card ``StreamingSparsePCA(n_components=50,
    n_features=30000)`` over the north star's counts in 131,072-row chunks
    (``partial_fit`` each, ``finalize``, ``transform`` each), bf16-exact:
    every slab densifies to bf16 in the fit and to float32 in the
    transform. Bars: EV against the north star's float64 truth (1e-5),
    the first chunk's scores against a float64 ``(X - mu) V^T`` on the card
    (1e-5 of max |score|), densify launches = 2 x slabs at those output
    types, no slab width the ``kernel`` phase did not hold. Then 131,072
    rows (16 slabs, a seeded sample) of the pipeline's log-normalized
    values (the float32 tier: float32 densify, float32 GEMM) against the
    float64 Gram of those rows (1e-5).
    -> the densify launches of both streams, and the fit's seconds and
    idle share (printed beside the mesh stream's)."""

    import numpy as np

    from single_algebra_tpu_torch.models import StreamingSparsePCA
    from single_algebra_tpu_torch.models import streaming_pca as smod
    from single_algebra_tpu_torch.ops import cuda_lib

    n, p = X.shape
    chunks = [X[r0:r0 + STREAM_CHUNK] for r0 in range(0, n, STREAM_CHUNK)]
    slabs = sum(-(-c.shape[0] // smod._SLAB) for c in chunks)
    widths: dict = {}
    payload = smod._slab_payload

    def recording(*args, **kwargs):  # the slab widths, for the held-width bar
        out = payload(*args, **kwargs)
        widths[out[2]] = widths.get(out[2], 0) + 1
        return out

    smod._slab_payload = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        pca = StreamingSparsePCA(n_components=K, n_features=p, device=DEVICE)
        for c in chunks:
            pca.partial_fit(c)
        pca.finalize()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = dict(cuda_lib.densify_launches_by_dtype)
        t0 = time.perf_counter()
        scores = [pca.transform(c) for c in chunks]
        torch.cuda.synchronize()
        transform_s = time.perf_counter() - t0
        launches = cuda_lib.launch_counts["tiled_ell_densify_t"]
        by_dtype = dict(cuda_lib.densify_launches_by_dtype)
        peak = torch.cuda.max_memory_allocated()
        by_wt = dict(sorted(widths.items()))

        # the host build against the upload, on the first chunk's slabs
        t0 = time.perf_counter()
        built = list(pca._built(chunks[0]))
        build_s = time.perf_counter() - t0
        wire = sum(td.nbytes + tl.nbytes for td, tl, *_ in built)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for td, tl, *_ in built:
            torch.from_numpy(td.view(np.int16) if td.dtype == np.uint16 else td).to(DEVICE)
            torch.from_numpy(tl).to(DEVICE)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        del built
        spare = StreamingSparsePCA(n_components=K, n_features=p, device=DEVICE)
        idle = device_idle(torch, lambda: spare.partial_fit(chunks[0]))
        del spare

        # the float32 tier: 16 slabs of the log-normalized values, rows drawn
        # from the whole matrix (its first 131,072 rows hold 9 of the 64
        # clusters: EVs 10-50 would be a flat noise tail, which no
        # randomized solve resolves to 1e-5)
        pick = np.sort(np.random.default_rng(0).choice(n, STREAM_CHUNK, replace=False))
        rows = Xl64[pick].astype(np.float32)
        widths.clear()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        pca32 = StreamingSparsePCA(n_components=K, n_features=p, device=DEVICE)
        pca32.partial_fit(rows).finalize()
        torch.cuda.synchronize()
        f32_fit_s = time.perf_counter() - t0
        f32_launches = cuda_lib.launch_counts["tiled_ell_densify_t"]
        f32_by_dtype = dict(cuda_lib.densify_launches_by_dtype)
        f32_by_wt = dict(sorted(widths.items()))
    finally:
        smod._slab_payload = payload

    ev_err = _ev_rel_err(pca.explained_variance_, ev_true)
    # the first chunk's scores against float64 on the card
    V = pca.components_.double()
    mu = pca.mean_.double()
    ref = torch.cat([
        (csr_dense_rows(torch, chunks[0], r0, min(r0 + 4096, STREAM_CHUNK), torch.float64,
                        DEVICE) - mu)
        @ V.T for r0 in range(0, STREAM_CHUNK, 4096)
    ])
    T0 = torch.from_numpy(scores[0]).to(DEVICE).double()
    score_err = float((T0 - ref).abs().max() / ref.abs().max())
    del ref, T0
    t0 = time.perf_counter()
    ev32_true, _ = f64_truth_ev(torch, rows, K, device=DEVICE)
    f32_truth_s = time.perf_counter() - t0
    ev32_err = _ev_rel_err(pca32.explained_variance_, ev32_true)
    ev32_worst = int(np.argmax(np.abs(np.asarray(pca32.explained_variance_, np.float64)
                                      - ev32_true)))

    emit("streaming", n=n, p=p, chunk_rows=STREAM_CHUNK, chunks=len(chunks), slabs=slabs,
         fit_s=fit_s, transform_s=transform_s, peak_alloc_gb=peak / 1e9,
         densify_launches=launches, densify_launches_fit=fit_launches,
         densify_launches_by_dtype=by_dtype, densify_launches_by_wt=by_wt,
         first_chunk_host_build_s=build_s, first_chunk_upload_s=upload_s,
         first_chunk_wire_mb=wire / 1e6, wire_mb_per_s=wire / upload_s / 1e6,
         partial_fit_idle=idle, ev_rel_err=ev_err, ev_target=EV_TARGET, ev_fail_above=EV_FAIL,
         score_rel_err_f64=score_err, score_fail_above=SCORE_REL_FAIL,
         scores_shape=[sum(len(t) for t in scores), K], held_widths=held_widths)
    emit("streaming_f32", rows=rows.shape[0], slabs=-(-rows.shape[0] // smod._SLAB),
         fit_s=f32_fit_s, densify_launches_by_dtype=f32_by_dtype, densify_launches_by_wt=f32_by_wt,
         ev_rel_err=ev32_err, ev_fail_above=EV_FAIL, worst_ev_index=ev32_worst,
         f64_truth_s=f32_truth_s, rows_from="a seeded sample of the whole matrix",
         truth="float64 Gram of the same rows, centered, subspace iteration")
    want = {"bfloat16": slabs, "float32": slabs}
    if fit_launches != {"bfloat16": slabs} or by_dtype != want or launches != 2 * slabs:
        raise AssertionError(f"streaming densify launches {by_dtype} (fit {fit_launches}): "
                             f"want {want}")
    f32_slabs = -(-rows.shape[0] // smod._SLAB)
    if f32_by_dtype != {"float32": f32_slabs}:
        raise AssertionError(f"float32-tier densify launches {f32_by_dtype}, want {f32_slabs}")
    unheld = (set(by_wt) | set(f32_by_wt)) - set(held_widths)
    if unheld:
        raise AssertionError(f"streaming slab widths {sorted(unheld)}: the kernel phase held "
                             f"{held_widths} only")
    if sum(len(t) for t in scores) != n or not all(np.isfinite(t).all() for t in scores):
        raise AssertionError("streaming scores misshapen or not finite")
    if not ev_err <= EV_FAIL:
        raise AssertionError(f"streaming EV rel err {ev_err} > {EV_FAIL}")
    if not score_err <= SCORE_REL_FAIL:
        raise AssertionError(f"streaming scores rel err {score_err} > {SCORE_REL_FAIL}")
    if not ev32_err <= EV_FAIL:
        raise AssertionError(f"float32-tier streaming EV rel err {ev32_err} > {EV_FAIL}")
    # what the mesh stream's line prints beside its own
    return launches + f32_launches, dict(fit_s=fit_s, idle=idle)


def make_blobs(n, d=50, nc=10, seed=0):
    """``benchmarks/tsne_large.py::make_blobs`` (that file imports JAX)."""

    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)) * 10.0
    labels = rng.integers(0, nc, n)
    x = (centers[labels] + rng.standard_normal((n, d))).astype(np.float32)
    return x, labels


def _sil64(torch, Y, lab):
    """Float64 silhouette values of the rows of ``Y`` against integer
    labels ``lab`` (all pairs): a = mean distance to the own cluster's
    other points, b = the least mean distance to another cluster, s = (b -
    a) / max(a, b) (0 for a point alone in its cluster)."""

    Y = Y.double()
    sq = (Y * Y).sum(dim=1)
    D = (sq[:, None] + sq[None, :] - 2.0 * (Y @ Y.T)).clamp_(min=0.0).sqrt_()
    D.fill_diagonal_(0.0)
    onehot = torch.nn.functional.one_hot(lab, int(lab.max()) + 1).double()
    sums, counts = D @ onehot, onehot.sum(dim=0)
    own = counts[lab] - 1
    a = sums.gather(1, lab[:, None])[:, 0] / own.clamp(min=1)
    other = (sums / counts.clamp(min=1)).scatter_(1, lab[:, None], float("inf"))
    other[:, counts == 0] = float("inf")
    b = other.min(dim=1).values
    return torch.where(own > 0, (b - a) / torch.maximum(a, b), torch.zeros_like(a))


def silhouette_on_card(torch, y, labels, sample: int, seed: int = 0) -> float:
    """Mean silhouette of ``sample`` points drawn without replacement
    (numpy seed), against their labels, in float64 on the card
    (``_sil64``)."""

    import numpy as np

    idx = np.random.default_rng(seed).choice(len(labels), sample, replace=False)
    return float(_sil64(torch, y[torch.from_numpy(idx).to(y.device)],
                        torch.from_numpy(labels[idx].astype(np.int64)).to(y.device)).mean())


def phase_tsne(torch) -> None:
    """Cell 11: ``tsne.run`` on ``make_blobs`` (10 clusters, d 50, seed 0),
    perplexity 30, 500 epochs: the knn mode at n = 50,000 (the shape of
    ``benchmarks/results_tsne_tpu.json``) and the exact mode at n =
    10,000. Bars: the gradient at a seeded y against a float64 evaluation
    of the same function on the card (1e-4 of max |g|), two evaluations
    bit for bit equal, finite output, and a silhouette of at least 0.7
    over 5,000 sampled points against the planted labels."""

    from single_algebra_tpu_torch.models import tsne
    from single_algebra_tpu_torch.models.umap import _knn_graph

    dev = torch.device(DEVICE)

    def step(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    failed = []
    for mode, n in (("knn", TSNE_KNN_N), ("exact", TSNE_EXACT_N)):
        x, labels = make_blobs(n)
        cfg = tsne.TSNEConfig(perplexity=30.0, epochs=TSNE_EPOCHS, mode=mode)
        xt = torch.from_numpy(x).to(dev)
        graph_s = None
        if mode == "knn":
            k = int(min(n - 1, round(3 * cfg.perplexity)))
            _, graph_s = step(lambda: _knn_graph(xt, k=k, block=min(2048, n)))
            (src, dst, val, lengths), setup_s = step(lambda: tsne._knn_affinities(xt, cfg))
            block = tsne._knn_block(n, cfg)

            def grad(y, v=val):
                return tsne._knn_grad(y, src, dst, v.to(y.dtype), 12.0, block=block,
                                      lengths=lengths)
        else:
            P, setup_s = step(lambda: tsne._exact_affinities(xt, cfg))

            def grad(y):
                return tsne._exact_grad(y, P.to(y.dtype), 12.0)

        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        y = 10.0 * torch.randn((n, cfg.output_dim), generator=gen, device=dev)
        g1, g2 = grad(y), grad(y)
        g64 = grad(y.double())
        grad_err = float((g1.double() - g64).abs().max() / g64.abs().max())
        identical = bool(torch.equal(g1, g2))
        grad_ms = _time_ms(torch, lambda: grad(y), 5)
        del g1, g2, g64
        torch.cuda.reset_peak_memory_stats()
        Y, total_s = step(lambda: tsne.run(x, cfg, device=DEVICE))
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(Y).all())
        sil = silhouette_on_card(torch, Y, labels, SIL_SAMPLE) if finite else float("nan")
        emit("tsne", mode=mode, n=n, d=x.shape[1], perplexity=cfg.perplexity, epochs=cfg.epochs,
             total_s=total_s, setup_s=setup_s, knn_graph_s=graph_s,
             epoch_ms=(total_s - setup_s) / cfg.epochs * 1e3, grad_ms=grad_ms,
             grad_rel_err_f64=grad_err, grad_fail_above=TSNE_GRAD_FAIL,
             grad_bit_identical=identical, finite=finite, silhouette=sil,
             silhouette_sample=SIL_SAMPLE, silhouette_fail_below=SIL_FAIL,
             peak_alloc_gb=peak / 1e9)
        if not (grad_err <= TSNE_GRAD_FAIL and identical and finite and sil >= SIL_FAIL):
            failed.append(mode)
        del Y, xt
        torch.cuda.empty_cache()
        if mode == "knn":
            timed("mesh_tsne", phase_mesh_tsne, torch, x, labels, cfg,
                  (total_s - setup_s) / cfg.epochs * 1e3)
    if failed:
        raise AssertionError(f"t-SNE {failed}: a bar of the tsne phase was not met")


def phase_sparse_engine(torch, ctx: dict) -> None:
    """The gather engine (``SparseOperator``, ``engine("sparse")``) on the
    pipeline's log-normalized matrix (its ELL layouts cached):
    ``lanczos_block(8)`` and the builder's defaults, held to the float64
    truth of the UNCENTERED Gram's top 50 (fail above 1e-5). Then its
    products ``mv`` / ``rmv`` at k 1, 8 and 64, timed beside their bound
    and one float32 ``torch.sparse_csr_tensor`` product, held to float64
    CSR products (fail above 1e-5 of max |truth|)."""

    import numpy as np
    import scipy.sparse as sp

    from single_algebra_tpu_torch import SparsePCABuilder
    from single_algebra_tpu_torch.linalg.operators import SparseOperator

    Xl, Xl64 = ctx["Xl"], ctx["Xl64"]
    n, p = Xl.shape
    G, _ = ctx.pop("gram")
    ritz, iters = f64_topk(torch, G, K)
    ev_true = (ritz / (n - 1)).cpu().numpy()
    del G, ritz
    torch.cuda.empty_cache()

    worst = 0.0
    for name, block in (("lanczos_block_8", 8), ("default_builder", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pca = SparsePCABuilder().n_components(K).engine("sparse").lanczos_block(block).build()
        T = pca.fit_transform(Xl)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        op = Xl._operator_cache.get("sparse")
        if not isinstance(op, SparseOperator):
            raise AssertionError(f"engine 'sparse' built {type(op).__name__}")
        if tuple(T.shape) != (n, K) or not bool(torch.isfinite(T).all()):
            raise AssertionError(f"sparse engine scores: shape {tuple(T.shape)}")
        err = _ev_rel_err(pca.explained_variance_, ev_true)
        worst = max(worst, err)
        emit("sparse_engine", method=name, n=n, p=p, fit_transform_s=seconds,
             steps=pca.lanczos_steps_taken_, fit_timings=pca._fit_timings,
             row_ell_width=op.row_data.shape[1], col_ell_width=op.col_data.shape[1],
             ev_rel_err_f64_truth_uncentered=err, fail_above=EV_FAIL,
             truth_subspace_iters=iters)
        del T
    if not worst <= EV_FAIL:
        raise AssertionError(f"sparse engine EV rel err {worst} > {EV_FAIL}")

    # the products, against float64 CSR products and one float32 library call
    t = Xl.transpose()
    Xt32 = sp.csr_matrix((t._csr_data_host(), t._h_indices, t._h_indptr), shape=(p, n))
    ref = Csr64Operator(torch, Xl64, DEVICE, Xt=Xt32.astype(np.float64))
    X32 = Xl64.astype(np.float32)
    lib_mv, lib_rmv = csr_on_card(torch, X32, torch.float32), csr_on_card(torch, Xt32, torch.float32)
    del X32, Xt32
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(9)
    stored = Xl.nnz
    for kk in (1, 8, 64):
        for name, fn, lib, width, out_len, layout in (
            ("mv", op.mv, lib_mv, p, n, (op.row_data, op.row_ids)),
            ("rmv", op.rmv, lib_rmv, n, p, (op.col_data, op.col_ids)),
        ):
            B = torch.randn((width, kk), generator=gen, device=DEVICE)
            want = (ref.mv if name == "mv" else ref.rmv)(B.double())
            err = float((fn(B).double() - want).abs().max() / want.abs().max())
            del want
            ms = _time_ms(torch, lambda: fn(B), 1)  # up to ~2 s a product at k 64
            lib_ms = _time_ms(torch, lambda: lib @ B, 3)
            moved = sum(a.numel() * a.element_size() for a in layout) + (width + out_len) * kk * 4
            bd = bound(moved, 2.0 * stored * kk)
            emit("sparse_engine_products", product=name, k=kk, ms=ms, **bd,
                 share_of_bound=bd["bound_ms"] / ms, library_ms=lib_ms,
                 library_call=f"float32 torch.sparse_csr_tensor {list(lib.shape)} @ dense",
                 rel_err_f64=err, fail_above=EV_FAIL)
            if not err <= EV_FAIL:
                raise AssertionError(f"SparseOperator.{name} k {kk}: rel err {err} > {EV_FAIL}")
            del B
    del ref, lib_mv, lib_rmv
    torch.cuda.empty_cache()


def _similarity_f64(torch, name, A, B):
    """The measures in float64 from their definitions (torch.cdist for
    the distances), independent of the port's code."""

    eps = torch.finfo(torch.float32).eps
    if name in ("cosine", "pearson"):
        if name == "pearson":
            A, B = A - A.mean(dim=1, keepdim=True), B - B.mean(dim=1, keepdim=True)
        den = A.norm(dim=1)[:, None] * B.norm(dim=1)[None, :]
        return torch.where(den > eps, (A @ B.T) / den.clamp(min=eps), torch.zeros_like(den))
    if name == "euclidean":  # differences, not the |x|^2 + |y|^2 - 2<x, y> expansion
        return torch.exp(-torch.cdist(A, B, compute_mode="donot_use_mm_for_euclid_dist"))
    if name == "manhattan":
        return torch.exp(-torch.cdist(A, B, p=1.0))
    out = torch.empty((A.shape[0], B.shape[0]), dtype=A.dtype, device=A.device)
    t = float(torch.finfo(torch.float64).eps)
    for r0 in range(0, A.shape[0], 64):  # jaccard, with the reference's quirks
        a = A[r0:r0 + 64, None, :]
        inter = ((a - B[None]).abs() < t).sum(dim=-1).double()
        union = ((a > 0) | (B[None] > 0)).sum(dim=-1).double()
        out[r0:r0 + 64] = torch.where(union > 0, inter / union.clamp(min=1), torch.zeros_like(union))
    return out


def phase_similarity(torch, T) -> None:
    """BASELINE config #5 over the pipeline's scores: cosine, euclidean
    and pearson ``pairwise`` on the first 50,000 rows (a [50000, 50000]
    float32 output), manhattan and jaccard on 5,000, each timed beside its
    bound and held to float64 on the first 1,024 rows against all: cosine
    and pearson at 1e-5 absolute, the others at 1e-5 of max |truth|. The
    euclidean bar leaves out the self-pairs: the expansion
    ``|x|^2 + |y|^2 - 2<x, y>`` cancels to float32 noise there (a few
    1e-5 of |x|^2), and its square root lifts that to ~1e-2 (the JAX
    package computes the same expansion); their error is printed."""

    from single_algebra_tpu_torch import similarity as S

    measures = (("cosine", S.CosineSimilarity(), SIM_ROWS, False),
                ("euclidean", S.EuclideanSimilarity(), SIM_ROWS, True),
                ("pearson", S.PearsonSimilarity(), SIM_ROWS, False),
                ("manhattan", S.ManhattanSimilarity(), SIM_L1_ROWS, True),
                ("jaccard", S.JaccardSimilarity(), SIM_L1_ROWS, True))
    failed = []
    for name, meas, rows, relative in measures:
        E = T[:rows].contiguous()
        out = meas.pairwise(E)
        torch.cuda.synchronize()
        want = _similarity_f64(torch, name, E[:SIM_CHECK_ROWS].double(), E.double())
        diff = (out[:SIM_CHECK_ROWS].double() - want).abs()
        scale = float(want.abs().max()) if relative else 1.0
        self_err = float(diff.diagonal().max()) / scale
        if name == "euclidean":
            diff.fill_diagonal_(0.0)
        err = float(diff.max()) / scale
        del diff, want, out
        torch.cuda.empty_cache()
        ms = _time_ms(torch, lambda: meas.pairwise(E), 3)
        d = E.shape[1]
        flops = 2.0 * rows * rows * d if name in ("cosine", "euclidean", "pearson") else 3.0 * rows * rows * d
        bd = bound(rows * d * 4 + rows * rows * 4, flops)
        emit("similarity", measure=name, rows=rows, dim=d, ms=ms, **bd,
             share_of_bound=bd["bound_ms"] / ms, err_f64=err, self_pair_err=self_err,
             relative_to_max=relative, fail_above=SIM_FAIL, rows_checked=SIM_CHECK_ROWS)
        if not err <= SIM_FAIL:
            failed.append((name, err))
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"similarity off its float64 values: {failed}")


def phase_masked_tiled(torch, m, X) -> None:
    """``MaskedSparsePCABuilder`` with ``lanczos_block(8)`` on the tiled
    path's matrix and cached engine (``MaskedOperator`` over
    ``TiledSparseOperator``), the mask the top 2,000 columns of the port's
    ``var_col``: both tiled kernels' launches counted from 0, the EVs held
    to the float64 UNCENTERED truth of ``X[:, mask]`` (a 2,000 x 2,000
    Gram from CSR; fail above 1e-5)."""

    import numpy as np

    from single_algebra_tpu_torch import MaskedSparsePCABuilder
    from single_algebra_tpu_torch.linalg.operators import TiledSparseOperator
    from single_algebra_tpu_torch.ops import cuda_lib

    n, p = m.shape
    t0 = time.perf_counter()
    mask = _top_mask(torch, m.var_col(), HVG).cpu().numpy()
    var_s = time.perf_counter() - t0
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pca = MaskedSparsePCABuilder().mask(mask).n_components(K).lanczos_block(8).build()
    T = pca.fit_transform(m)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {kn: cuda_lib.launch_counts[kn] for kn in ("tiled_ell_spmm_t", "tiled_ell_rmv_t")}
    op = m._operator_cache.get("auto")
    if not isinstance(op, TiledSparseOperator) or min(launches.values()) <= 0:
        raise AssertionError(f"masked tiled fit: engine {type(op).__name__}, launches {launches}")
    if tuple(T.shape) != (n, K) or not bool(torch.isfinite(T).all()):
        raise AssertionError(f"masked tiled scores: shape {tuple(T.shape)}")
    t0 = time.perf_counter()
    Xm = X[:, np.where(mask)[0]].astype(np.float64)
    Gm = torch.from_numpy((Xm.T @ Xm).toarray()).to(DEVICE)
    ev_true = (torch.linalg.eigvalsh(Gm).flip(0)[:K] / (n - 1)).cpu().numpy()
    truth_s = time.perf_counter() - t0
    err = _ev_rel_err(pca.explained_variance_, ev_true)
    emit("masked_tiled", n=n, p=p, hvg=HVG, engine="MaskedOperator over TiledSparseOperator",
         var_col_mask_s=var_s, col_ell_build_s=m.transpose().ell_build_seconds,
         warm_engine_fit_transform_s=seconds, block_steps=pca.lanczos_steps_taken_,
         launches=launches, ev_rel_err_f64_truth_uncentered=err, fail_above=EV_FAIL,
         truth_s=truth_s, ev_top3=np.asarray(pca.explained_variance_)[:3].tolist(),
         ev_true_top3=ev_true[:3].tolist())
    if not err <= EV_FAIL:
        raise AssertionError(f"masked tiled EV rel err {err} > {EV_FAIL}")
    m._transpose_cache = None  # the column layout: not needed past this phase


# --------------------------------------------------------------------------
# the mesh layer: four mesh entries on the one card
# --------------------------------------------------------------------------


def ari(labels_a, labels_b) -> float:
    """Adjusted Rand index of two labelings (host numpy; the port does not
    ship ``metrics.py`` yet)."""

    import numpy as np

    _, a = np.unique(labels_a, return_inverse=True)
    _, b = np.unique(labels_b, return_inverse=True)
    nb = int(b.max()) + 1
    table = np.bincount(a * nb + b, minlength=(int(a.max()) + 1) * nb).astype(np.float64)
    table = table.reshape(-1, nb)

    def pairs(x):
        return float((x * (x - 1) / 2).sum())

    s, sa, sb = pairs(table), pairs(table.sum(axis=1)), pairs(table.sum(axis=0))
    expected = sa * sb / pairs(np.array([len(a)], np.float64))
    return (s - expected) / (0.5 * (sa + sb) - expected)


def _ulp_max(torch, approx, exact64) -> float:
    """Largest error of a float32 result in ULPs of the float32 rounding of
    its float64 value."""

    ref = exact64.float().abs()
    spacing = (torch.nextafter(ref, torch.full_like(ref, float("inf"))) - ref).double()
    ok = ref > 0
    return float(((approx.double() - exact64).abs()[ok] / spacing[ok]).max())


def _line_sums64(indptr, vals64):
    """Per-line sums of CSR values in float64 (a running sum: exact for the
    integer counts here, whose totals stay below 2^53)."""

    import numpy as np

    cs = np.concatenate([[0.0], np.cumsum(vals64)])
    return cs[indptr[1:]] - cs[indptr[:-1]]


def _modularity64(adj, labels, resolution: float) -> float:
    """RBConfiguration quality of ``labels`` in float64 over the symmetric
    CSR ``adj`` Leiden clustered."""

    import numpy as np

    coo = adj.tocoo()
    w = coo.data.astype(np.float64)
    strength = np.bincount(coo.row, w, adj.shape[0])
    m2 = strength.sum()
    intra = w[labels[coo.row] == labels[coo.col]].sum()
    tot = np.bincount(labels, strength)
    return float(intra / m2 - resolution * ((tot / m2) ** 2).sum())


def _zheng17_truth(m, rows: int, info: dict, check_rows):
    """``recipe_zheng17``'s Z on ``check_rows`` in float64 on the host, from
    the counts' first ``rows`` rows with the recipe's masks and first
    target: row totals, the first normalization, the HVG columns, the
    second normalization to the median of their row totals, log1p, the
    column means and Bessel standard deviations over all ``rows`` rows,
    the upper clip."""

    import numpy as np
    import scipy.sparse as sp

    ip = m._h_indptr[: rows + 1]
    rs = _line_sums64(ip, m._h_data[: ip[-1]].astype(np.float64))
    fac1 = np.where(rs > 0, info["target_sum"] / np.where(rs > 0, rs, 1.0), 1.0)
    col = m.transpose()  # its host CSC arrays: the HVG columns without a scipy slice
    cols = np.where(info["gene_mask"])[0]
    cip = col._h_indptr
    lens = cip[cols + 1] - cip[cols]
    pos = np.repeat(cip[cols] - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    pos += np.arange(int(lens.sum()))
    r = col._h_indices[pos].astype(np.int64)
    keep = r < rows
    r = r[keep]
    v = col._h_data[pos][keep].astype(np.float64) * fac1[r]
    c = np.repeat(np.arange(len(cols)), lens)[keep]
    sub = sp.csr_matrix((v, (r, c)), shape=(rows, len(cols)))
    rs2 = np.asarray(sub.sum(axis=1)).ravel()
    target2 = float(np.median(rs2[rs2 > 0]))
    fac2 = np.where(rs2 > 0, target2 / np.where(rs2 > 0, rs2, 1.0), 1.0)
    sub = sp.diags(fac2) @ sub
    sub.data = np.log1p(sub.data)
    mean = np.asarray(sub.sum(axis=0)).ravel() / rows
    sq = np.asarray(sub.multiply(sub).sum(axis=0)).ravel() / rows
    std = np.sqrt(np.maximum((sq - mean * mean) * rows / (rows - 1), 0.0))
    std = np.where(std > 0, std, 1.0)
    Z = (sub[check_rows].toarray() - mean) / std
    return np.minimum(Z, ZHENG_SCALE_MAX)


def phase_scrna(torch, m, ctx: dict, held_widths) -> int:
    """Cell 13: the JAX repo's own workflow (``examples/scrna_pipeline.py``)
    on cell 1's counts ``m`` and the pipeline's log-normalized ``Xl``,
    through the port's entry points: ``calculate_qc_metrics`` (mito: every
    13th gene) -> ``highly_variable_genes`` (seurat, 2,000) ->
    ``MaskedSparsePCABuilder``'s defaults (the pipeline's cached Gram
    engine: warm) -> ``neighbors.connectivities(E, 15)`` (IVF above 200k
    rows) -> ``leiden`` (resolution 0.5) -> ``KMeans(64)`` -> ``UMAP`` ->
    ``recipe_zheng17`` on the counts. Bars: QC counts and totals exact
    against the host CSR in float64; ``torch.expm1`` within 3 ULP;
    ``dispersions_norm`` within 1e-5 (of the largest) of a float64 host
    recompute, the mask the truth's but for genes that close to the
    cutoff; masked EVs within 1e-5 of the float64 masked truth; IVF
    recall@15 >= 0.95 on 20,000 sampled queries against the exact
    ``cross_knn`` (a neighbor as near as the exact k-th counts: ties
    aside), the exact picks' float64 distances within 1e-4 (of the k-th)
    of the float64 k nearest on 1,000 rows; every row's
    memberships sum to log2(15) within 1e-3 (floored-sigma rows aside);
    the graph symmetric; Leiden native, its quality the float64
    modularity within 1e-6; one UMAP epoch within 1e-4 of max |update| of
    a float64 CPU recompute with the same draws, bit for bit on repeat;
    Z on 2,000 rows within 1e-5 of max |Z| of a float64 host recompute.
    -> the densify launches of the masked fit, and what the analysis
    phases reuse: the matrices, scores, graph, Leiden labels, layout and
    HVG mask."""

    import numpy as np

    from single_algebra_tpu_torch import (
        MaskedSparsePCABuilder,
        calculate_qc_metrics,
        highly_variable_genes,
        leiden,
        neighbors,
        recipe_zheng17,
    )
    from single_algebra_tpu_torch.feature_selection import _normalized_dispersion
    from single_algebra_tpu_torch.linalg.gram import GramPCAEngine
    from single_algebra_tpu_torch.models import KMeans, UMAP, UMAPConfig
    from single_algebra_tpu_torch.models import umap as umod
    from single_algebra_tpu_torch.ops import cuda_lib
    from single_algebra_tpu_torch.ops.stats import valid_mask

    n, p = m.shape
    Xl, Xl64 = ctx["Xl"], ctx["Xl64"]
    sizes = np.full(64, n // 64)
    sizes[: n % 64] += 1
    planted = np.repeat(np.arange(64), sizes)  # the generator's row clusters
    steps, checks, failed = {}, {}, []

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    def bar(name, ok, **fields):
        checks[name] = dict(ok=bool(ok), **fields)
        if not ok:
            failed.append(name)

    torch.cuda.reset_peak_memory_stats()

    # 1. QC against the host CSR arrays in float64 (reduced on the card: the
    # sums are exact integers in float64 whatever the order)
    mito = np.zeros(p, bool)
    mito[::13] = True
    obs, var = step("qc", lambda: calculate_qc_metrics(m, qc_vars={"mito": mito}))
    t0 = time.perf_counter()
    col = m.transpose()
    dev = torch.device(DEVICE)
    v64 = torch.from_numpy(m._h_data).to(dev).double()
    cols_t = torch.from_numpy(m._h_indices).to(dev).long()
    rows_t = torch.repeat_interleave(torch.arange(n, device=dev),
                                     torch.from_numpy(np.diff(m._h_indptr)).to(dev))
    row_tot = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, rows_t, v64)
    mito_t = torch.from_numpy(mito).to(dev)[cols_t]
    mito_tot = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, rows_t, torch.where(mito_t, v64, torch.zeros_like(v64)))
    col_tot = torch.zeros(p, dtype=torch.float64, device=dev).index_add_(0, cols_t, v64)
    del v64, cols_t, rows_t, mito_t
    qc_exact = (np.array_equal(obs["n_genes_by_counts"], np.diff(m._h_indptr))
                and np.array_equal(obs["total_counts"], row_tot.cpu().numpy())
                and np.array_equal(obs["total_counts_mito"], mito_tot.cpu().numpy())
                and np.array_equal(var["n_cells_by_counts"], np.diff(col._h_indptr))
                and np.array_equal(var["total_counts"], col_tot.cpu().numpy()))
    bar("qc_exact", qc_exact, truth_s=time.perf_counter() - t0)
    del row_tot, mito_tot, col_tot

    # 2. torch.expm1 on the card over the log-normalized values
    d, ids, row_nnz = Xl._device_layout()
    v = d[valid_mask(ids, row_nnz)]
    expm1_ulp = _ulp_max(torch, torch.expm1(v), torch.expm1(v.double()))
    bar("expm1_ulp", expm1_ulp <= LOG1P_ULP_FAIL, max_ulp=expm1_ulp, values=v.numel(),
        value_range=[float(v.min()), float(v.max())], fail_above=LOG1P_ULP_FAIL)
    del d, ids, row_nnz, v

    # 3. HVG against a float64 host recompute
    hvg = step("hvg", lambda: highly_variable_genes(Xl, n_top_genes=SCRNA_HVG, flavor="seurat"))
    t0 = time.perf_counter()
    ex = torch.expm1(torch.from_numpy(Xl64.data).to(dev))
    cols_t = torch.from_numpy(Xl64.indices).to(dev).long()
    s64 = torch.zeros(p, dtype=torch.float64, device=dev).index_add_(0, cols_t, ex)
    sq64 = torch.zeros(p, dtype=torch.float64, device=dev).index_add_(0, cols_t, ex * ex)
    s64, sq64 = s64.cpu().numpy(), sq64.cpu().numpy()
    del ex, cols_t
    mean64 = s64 / n
    var64 = np.maximum(sq64 / n - mean64 * mean64, 0.0) * (n / (n - 1))
    _, norm64 = _normalized_dispersion(mean64, var64, "seurat", 20)
    scale = float(np.abs(norm64).max())
    hvg_err = float(np.abs(np.asarray(hvg.dispersions_norm, np.float64) - norm64).max() / scale)
    order = np.argsort(-norm64, kind="stable")
    mask64 = np.zeros(p, bool)
    mask64[order[:SCRNA_HVG]] = True
    cutoff = norm64[order[SCRNA_HVG - 1]]
    near = np.abs(norm64 - cutoff) <= HVG_FAIL * scale
    off = int(((hvg.mask != mask64) & ~near).sum())
    bar("hvg", hvg_err <= HVG_FAIL and off == 0, truth_s=time.perf_counter() - t0,
        dispersions_norm_rel_err=hvg_err,
        fail_above=HVG_FAIL, mask_mismatch_beyond_cutoff=off, genes_near_cutoff=int(near.sum()),
        selected=hvg.n_selected)

    # 4. the masked fit on the pipeline's cached Gram engine (warm)
    cuda_lib.reset_launch_counts()
    pca = MaskedSparsePCABuilder().mask(hvg.mask).n_components(K).build()
    E = step("masked_pca", lambda: pca.fit_transform(Xl))
    launches = cuda_lib.launch_counts["tiled_ell_densify_t"]
    by_dtype = dict(cuda_lib.densify_launches_by_dtype)
    eng = Xl._operator_cache.get("auto")
    is_gram = isinstance(eng, GramPCAEngine)
    widths = sorted({int(wt) for wt, _ in eng.bwidths}) if is_gram else []
    t0 = time.perf_counter()
    ev_raw, _, _ = f64_truth_ev(torch, Xl64, K, uncentered=True, cols=np.where(hvg.mask)[0],
                                gram=ctx["gram"])
    ev_truth_s = time.perf_counter() - t0
    ev_err = _ev_rel_err(pca.explained_variance_, ev_raw)
    bar("masked_ev", is_gram and ev_err <= EV_FAIL and launches > 0
        and set(widths) <= set(held_widths) and tuple(E.shape) == (n, K),
        engine=type(eng).__name__, ev_rel_err=ev_err, fail_above=EV_FAIL, truth_s=ev_truth_s,
        densify_launches=launches, densify_launches_by_dtype=by_dtype,
        bucket_widths=widths, held_widths=held_widths)
    del pca, eng
    Xl._operator_cache.clear()
    torch.cuda.empty_cache()
    E = E.contiguous()

    # 5. the neighbor graph (IVF: n > 200k); the IVF neighbors it drew are
    # recorded for the bars
    ivf_knn, drawn = neighbors.ivf_knn, []

    def recording(*args, **kwargs):
        out = ivf_knn(*args, **kwargs)
        drawn.append(out)
        return out

    neighbors.ivf_knn = recording
    try:
        S = step("connectivities", lambda: neighbors.connectivities(E, SCRNA_NEIGHBORS))
    finally:
        neighbors.ivf_knn = ivf_knn
    (D, I), = drawn
    bar("graph_symmetric", (S != S.T).nnz == 0, nnz=int(S.nnz))
    # the index again (the same seeded build): its lists, and the launches
    # and seconds of the recall queries' search (one profiler window)
    L, npr = neighbors._ivf_plan(n)
    t0 = time.perf_counter()
    index, ivf_build_s = _synced(torch, lambda: neighbors._IvfIndex(
        E, neighbors._ivf_centroids(E, L, 0)))
    q = torch.from_numpy(np.sort(np.random.default_rng(3).choice(
        n, SCRNA_RECALL_QUERIES, replace=False))).to(E.device)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, ivf_search_s = _synced(torch, lambda: index.search(E[q], q, k=SCRNA_NEIGHBORS,
                                                             n_probe=npr))
    ivf_kernels = sum(1 for e in prof.events()
                      if e.device_type == DeviceType.CUDA and not e.name.startswith("Mem"))
    del prof
    k = SCRNA_NEIGHBORS
    ed_, ei_ = neighbors.cross_knn(E[q], E, k + 1)
    first = torch.argsort((ei_ == q[:, None]).to(torch.int8), dim=1, stable=True)[:, :k]
    ed_, ei_ = ed_.gather(1, first), ei_.gather(1, first)  # the self-hit dropped
    recall_ids = float((I[q][:, :, None] == ei_[:, None, :]).any(dim=2).sum()) / ei_.numel()
    # ties aside: an IVF neighbor counts when it is as near as the exact k-th
    kth = ed_[:, -1:]
    recall = float((D[q] <= kth * (1 + RECALL_TIE)).sum(dim=1).clamp(max=k).sum()) / ei_.numel()
    # the exact kNN itself: the float64 distances of its picks against the
    # float64 k nearest, on the first checked rows
    E64 = E.double()
    sq64 = (E64 * E64).sum(dim=1)
    exact_err = 0.0
    for r0 in range(0, SCRNA_F64_ROWS, 250):
        rows = q[r0:r0 + 250]
        d64 = sq64[rows, None] - 2.0 * (E64[rows] @ E64.T) + sq64[None, :]
        d64.scatter_(1, rows[:, None], float("inf"))
        best = torch.sqrt(torch.clamp(-torch.topk(-d64, k, dim=1).values, min=0.0))
        picked = torch.sqrt(torch.clamp(d64.gather(1, ei_[r0:r0 + 250]), min=0.0))
        picked = torch.sort(picked, dim=1).values
        exact_err = max(exact_err, float(((picked - best).abs() / best[:, -1:].clamp(
            min=1e-30)).max()))
        del d64
    del E64, sq64
    rho, sigma = umod._smooth_knn(D)
    W = torch.exp(-torch.clamp(D - rho[:, None], min=0.0) / sigma[:, None])
    floor = float(1e-3 * D.mean())
    free = sigma > floor * (1 + 1e-6)
    memb_err = float((W.sum(dim=1) - float(np.log2(SCRNA_NEIGHBORS))).abs()[free].max())
    bar("ivf", recall >= RECALL_FAIL and exact_err <= EXACT_KNN_F64_FAIL
        and memb_err <= MEMBERSHIP_FAIL, recall_at_15=recall, fail_below=RECALL_FAIL,
        recall_at_15_same_ids=recall_ids, tie_tolerance=RECALL_TIE,
        queries=SCRNA_RECALL_QUERIES, exact_f64_dist_rel_err=exact_err,
        exact_rows_f64=SCRNA_F64_ROWS, exact_fail_above=EXACT_KNN_F64_FAIL,
        membership_sum_err=memb_err, membership_fail_above=MEMBERSHIP_FAIL,
        floored_rows=int((~free).sum()), n_lists=L, cap=index.cap, n_probe=npr,
        mean_list=n / L, list_store_gb=(index.Xs.numel() * 4 + index.ids.numel() * 8) / 1e9,
        padded_store_gb=L * index.cap * E.shape[1] * 4 / 1e9, build_s=ivf_build_s,
        recall_queries_search_s_profiled=ivf_search_s,
        recall_queries_cuda_kernels=ivf_kernels,
        truth_s=time.perf_counter() - t0 - ivf_build_s - ivf_search_s)
    del index, D, I, W, rho, sigma, ed_, ei_

    # 6. Leiden
    lr = step("leiden", lambda: leiden(S, resolution=SCRNA_RESOLUTION, seed=0))
    t0 = time.perf_counter()
    adj = S.astype(np.float32)  # what leiden clustered: S is symmetric (checked above)
    adj.eliminate_zeros()
    q64 = _modularity64(adj, lr.labels, SCRNA_RESOLUTION)
    del adj
    bar("leiden", lr.backend == "native" and abs(lr.quality - q64) <= MODULARITY_FAIL,
        backend=lr.backend, quality=lr.quality, quality_f64=q64, fail_above=MODULARITY_FAIL,
        truth_s=time.perf_counter() - t0,
        communities=lr.n_communities, ari_planted=ari(lr.labels, planted))

    # 7. KMeans
    km = step("kmeans", lambda: KMeans(SCRNA_KMEANS, n_init=1).fit(E))
    bar("kmeans", bool(torch.isfinite(km.cluster_centers_).all()), iterations=km.n_iter_,
        inertia=km.inertia_, ari_planted=ari(km.labels_.cpu().numpy(), planted))
    del km

    # 8. UMAP, then one epoch against float64 on the CPU with the same draws
    um = UMAP(UMAPConfig(n_neighbors=SCRNA_NEIGHBORS, n_epochs=UMAP_EPOCHS))
    Y = step("umap", lambda: um.fit_transform(E))
    ed = um.graph_
    a, b = umod._fit_ab(1.0, 0.1)
    gen = torch.Generator(device=E.device)
    gen.manual_seed(5)
    active = torch.rand(ed.heads.shape[0], generator=gen, device=E.device) < ed.weights
    negs = torch.randint(0, n, (ed.heads.shape[0], 5), generator=gen, device=E.device)
    alpha = umod._alpha(1.0, 0, UMAP_EPOCHS)
    Y1 = umod._layout_epoch(Y, ed, active, negs, alpha, a, b)
    Y1b = umod._layout_epoch(Y, ed, active, negs, alpha, a, b)
    epoch_identical = bool(torch.equal(Y1, Y1b))
    upd = (Y1 - Y).cpu().double()
    del Y1b
    cpu = type(ed).__new__(type(ed))
    for attr, val in vars(ed).items():
        setattr(cpu, attr, val.cpu() if isinstance(val, torch.Tensor) else val)
    t0 = time.perf_counter()
    Y64 = Y.cpu().double()
    upd64 = umod._layout_epoch(Y64, cpu, active.cpu(), negs.cpu(), alpha, a, b) - Y64
    cpu_epoch_s = time.perf_counter() - t0
    del cpu, Y64, active, negs
    epoch_err = float((upd - upd64).abs().max() / upd64.abs().max())

    def layout():
        g = torch.Generator(device=E.device)
        g.manual_seed(7)
        return umod._optimize_layout(Y, ed, g, n_epochs=UMAP_REPEAT_EPOCHS, neg_rate=5,
                                     a=a, b=b, lr=1.0)

    Ya = layout()
    Yb, repeat_s = _synced(torch, layout)
    runs_identical = bool(torch.equal(Ya, Yb))
    del Ya, Yb
    bar("umap", epoch_err <= UMAP_EPOCH_FAIL and epoch_identical and runs_identical
        and tuple(Y.shape) == (n, 2) and bool(torch.isfinite(Y).all()),
        epoch_rel_err_f64=epoch_err, fail_above=UMAP_EPOCH_FAIL, cpu_f64_epoch_s=cpu_epoch_s,
        epoch_bit_identical=epoch_identical, layout_repeat_bit_identical=runs_identical,
        epochs=UMAP_EPOCHS, edges=int(ed.heads.shape[0]),
        ms_per_epoch=repeat_s / UMAP_REPEAT_EPOCHS * 1e3,
        silhouette_planted=silhouette_on_card(torch, Y, planted, SIL_SAMPLE))
    del um, ed, upd, upd64
    torch.cuda.empty_cache()

    # 9. recipe_zheng17 on the counts
    mz = m if ZHENG_ROWS >= n else m.select_rows(np.arange(ZHENG_ROWS))
    Z, info = step("recipe_zheng17", lambda: recipe_zheng17(mz))
    rows = min(ZHENG_ROWS, n)
    chk = np.sort(np.random.default_rng(4).choice(rows, ZHENG_CHECK_ROWS, replace=False))
    t0 = time.perf_counter()
    Zt = _zheng17_truth(m, rows, info, chk)
    zheng_truth_s = time.perf_counter() - t0
    Zc = Z[torch.from_numpy(chk).to(Z.device)].cpu().numpy().astype(np.float64)
    z_err = float(np.abs(Zc - Zt).max() / np.abs(Zt).max())
    bar("zheng17", z_err <= ZHENG_FAIL and tuple(Z.shape) == (rows, 1000)
        and bool(torch.isfinite(Z).all()), z_rel_err_f64=z_err, fail_above=ZHENG_FAIL,
        rows=rows, check_rows=ZHENG_CHECK_ROWS, truth_s=zheng_truth_s,
        z_shape=list(Z.shape), hvg_selected=int(info["hvg"].n_selected))
    del Z, mz
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    emit("scrna", n=n, p=p, steps_s=steps, peak_alloc_gb=peak / 1e9, checks=checks,
         card=card())
    if failed:
        raise AssertionError(f"scrna: bars not met: {failed}")
    return launches, dict(Xl=Xl, Xl64=Xl64, E=E, Y=Y, S=S, labels=lr.labels,
                          hvg_mask=hvg.mask, hvg=hvg, qc=(obs, var))


def phase_scrna_blobs(torch) -> dict:
    """Cell 13 on the t-SNE phase's blobs (50,000 x 50, 10 clusters): exact
    ``connectivities`` -> ``leiden``, ``KMeans(10, n_init=3)`` and ``UMAP`` against
    the planted labels (ARI >= 0.9, ARI >= 0.9, silhouette of 5,000
    sampled points >= 0.7), then the ``mesh=`` branches on
    ``Mesh((cuda:0,) * 4)``: the graph identical to the single card's,
    KMeans from the same centers within 1e-5 (of the largest |center|),
    the same labels. -> the blobs, their graph and Leiden labels."""

    import numpy as np

    from single_algebra_tpu_torch import leiden, neighbors
    from single_algebra_tpu_torch.models import KMeans, UMAP, UMAPConfig
    from single_algebra_tpu_torch.models import kmeans as kmod

    x, labels = make_blobs(TSNE_KNN_N)
    xt = torch.from_numpy(x).to(DEVICE)
    steps, checks, failed = {}, {}, []

    def step(name, fn):
        out, steps[name] = _synced(torch, fn)
        return out

    def bar(name, ok, **fields):
        checks[name] = dict(ok=bool(ok), **fields)
        if not ok:
            failed.append(name)

    S = step("connectivities", lambda: neighbors.connectivities(xt, SCRNA_NEIGHBORS))
    lr = step("leiden", lambda: leiden(S, resolution=SCRNA_RESOLUTION, seed=0))
    a_l = ari(lr.labels, labels)
    bar("leiden", a_l >= ARI_FAIL and lr.backend == "native", ari=a_l, fail_below=ARI_FAIL,
        communities=lr.n_communities, backend=lr.backend)
    # three k-means++ starts, the example's setting: a single start merged two
    # of these blobs for one seed in five (the port on the CPU, 5,000 points)
    km = step("kmeans", lambda: KMeans(10, n_init=3).fit(xt))
    a_k = ari(km.labels_.cpu().numpy(), labels)
    bar("kmeans", a_k >= ARI_FAIL, ari=a_k, fail_below=ARI_FAIL, iterations=km.n_iter_)
    Y = step("umap", lambda: UMAP(UMAPConfig(n_neighbors=SCRNA_NEIGHBORS,
                                             n_epochs=UMAP_EPOCHS)).fit_transform(xt))
    sil = silhouette_on_card(torch, Y, labels, SIL_SAMPLE) if bool(torch.isfinite(Y).all()) \
        else float("nan")
    bar("umap", sil >= SIL_FAIL, silhouette=sil, fail_below=SIL_FAIL)
    del Y

    mesh = card_mesh(torch)
    Sm = step("connectivities_mesh", lambda: neighbors.connectivities(xt, SCRNA_NEIGHBORS,
                                                                      mesh=mesh))
    same = (S.shape == Sm.shape and np.array_equal(S.indptr, Sm.indptr)
            and np.array_equal(S.indices, Sm.indices))
    diff = float(np.abs(S.data - Sm.data).max()) if same else float("inf")
    bar("connectivities_mesh", same and diff == 0.0, max_abs_diff=diff)
    x2 = kmod._row_sq_norms(xt)
    gen = torch.Generator(device=xt.device)
    gen.manual_seed(11)
    w = torch.ones(xt.shape[0], device=xt.device)
    C0 = kmod._plusplus_init(gen, xt, x2, w, 10)
    tol2 = KMeans(10)._tol2(xt)
    single = step("kmeans_lloyd", lambda: kmod._lloyd(xt, x2, tol2, C0, w, k=10, max_iter=300))
    meshed = step("kmeans_lloyd_mesh", lambda: kmod._lloyd_mesh(mesh, xt, x2, tol2, C0, k=10,
                                                                max_iter=300))
    c_err = float((meshed[0] - single[0]).abs().max() / single[0].abs().max())
    bar("kmeans_mesh", c_err <= KMEANS_MESH_FAIL and torch.equal(meshed[1], single[1]),
        center_rel_err=c_err, fail_above=KMEANS_MESH_FAIL, iterations=[single[3], meshed[3]])
    emit("scrna_blobs", n=x.shape[0], d=x.shape[1], clusters=10, entries=mesh.size,
         steps_s=steps, checks=checks, card=card())
    if failed:
        raise AssertionError(f"scrna blobs: bars not met: {failed}")
    return dict(x=x, labels=labels, S=S, leiden=lr.labels)


def planted_doublets(X, rows: int, rate: float, seed: int, n_clusters: int = 64):
    """One 10x lane of ``X``'s cells with planted doublets: ``rows`` rows
    drawn without replacement (numpy seed), the first ``rate`` share of
    them replaced by its sum with a drawn cell of another generator
    cluster (``cluster_counts_big`` lays its clusters out in equal row
    blocks), the rows then shuffled. -> (scipy CSR [rows, p] float32,
    is_doublet [rows] bool)."""

    import numpy as np
    import scipy.sparse as sp

    n = X.shape[0]
    sizes = np.full(n_clusters, n // n_clusters)
    sizes[: n % n_clusters] += 1
    cluster = np.repeat(np.arange(n_clusters), sizes)
    rng = np.random.default_rng(seed)
    pick = rng.choice(n, rows, replace=False)
    n_doub = int(round(rate * rows))
    a = pick[:n_doub]
    b = rng.choice(n, n_doub)
    same = cluster[a] == cluster[b]
    while same.any():
        b[same] = rng.choice(n, int(same.sum()))
        same = cluster[a] == cluster[b]
    out = sp.vstack([X[a] + X[b], X[pick[n_doub:]]]).tocsr().astype(np.float32)
    is_doublet = np.arange(rows) < n_doub
    perm = rng.permutation(rows)
    return out[perm], is_doublet[perm]


def auroc(scores, truth) -> float:
    """Area under the ROC curve of ``scores`` for the boolean ``truth``
    (tie-averaged ranks)."""

    from scipy.stats import rankdata

    r = rankdata(scores)
    n1, n0 = int(truth.sum()), int((~truth).sum())
    return float((r[truth].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def nmi64(a, b) -> float:
    """Normalized mutual information (arithmetic mean), float64 host."""

    import numpy as np

    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    C = np.zeros((ia.max() + 1, ib.max() + 1))
    np.add.at(C, (ia, ib), 1.0)
    P = C / C.sum()
    pa, pb = P.sum(axis=1), P.sum(axis=0)
    nz = P > 0
    mi = float((P[nz] * np.log(P[nz] / np.outer(pa, pb)[nz])).sum())
    ha = float(-(pa[pa > 0] * np.log(pa[pa > 0])).sum())
    hb = float(-(pb[pb > 0] * np.log(pb[pb > 0])).sum())
    return mi / ((ha + hb) / 2)


def _entries_on_card(torch, M):
    """(rows, cols, float64 values) of a host CSR's stored entries, on the card."""

    import numpy as np

    device = DEVICE
    rows = torch.repeat_interleave(torch.arange(M.shape[0], device=device),
                                   torch.from_numpy(np.diff(M.indptr)).to(device))
    return (rows, torch.from_numpy(M.indices.astype(np.int64)).to(device),
            torch.from_numpy(M.data).to(device).double())


def _ranks64(torch, x):
    """1-based tie-averaged ranks of each row of the float64 ``x`` and the
    tie term sum(t^3 - t) per row, by ``unique_consecutive`` of the sorted
    row (an independent route from the port's scans)."""

    ranks = torch.empty_like(x)
    ties = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
    for i in range(x.shape[0]):
        s, order = torch.sort(x[i])
        _, counts = torch.unique_consecutive(s, return_counts=True)
        c = counts.double()
        start = torch.cumsum(c, 0) - c
        ranks[i, order] = torch.repeat_interleave(start + (c + 1.0) / 2.0, counts)
        ties[i] = (c * c * c - c).sum()
    return ranks, ties


def _rest_t64(sums, sumsq, sizes, i, overestim: bool):
    """Welch t of group ``i`` against the rest from float64 grouped sums
    (the definition: moments of the group's cells and of all others)."""

    import numpy as np

    n1, n2 = sizes[i], sizes.sum() - sizes[i]
    m1 = sums[:, i] / n1
    v1 = (sumsq[:, i] - sums[:, i] * m1) / max(n1 - 1, 1)
    s2, q2 = sums.sum(axis=1) - sums[:, i], sumsq.sum(axis=1) - sumsq[:, i]
    m2 = s2 / n2
    v2 = np.maximum((q2 - s2 * m2) / max(n2 - 1, 1), 0.0)
    d = np.sqrt(np.maximum(v1, 0.0) / n1 + v2 / (n1 if overestim else n2))
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(d > 0, (m1 - m2) / np.where(d > 0, d, 1.0), 0.0)


def _by_gene(res, g, field="scores"):
    """A ``DEResult`` column back in gene order."""

    import numpy as np

    out = np.empty(len(res.names[g]))
    out[np.asarray(res.names[g], np.int64)] = getattr(res, field)[g]
    return out


def phase_de(torch, sc: dict) -> dict:
    """The example's last step (``examples/scrna_pipeline.py``):
    ``rank_genes_groups`` on the pipeline's log-normalized 1M x 30k matrix
    and the ``scrna`` phase's Leiden labels, with 'wilcoxon', 't-test' and
    't-test_overestim_var', ``pts=True``; then 'logreg' on the first
    100,000 rows. Bars (float64 truths reduced on the card from the host
    CSR values): the grouped means and variances within 1e-6 of the
    largest |truth|; t within 1e-5 of max |t|; Wilcoxon z of 64 seeded
    genes over every group within 1e-4 of max(1, |z|) against float64
    tie-averaged ranks; each group's top 5 names the float64 top 5
    wherever its 5th and 6th t are further apart than the t bar; ``pts``
    exact; a Wilcoxon block bit for bit on repeat; the logreg
    coefficients within 1e-4 of max |W| of a float64 run of the same 300
    steps from the same start."""

    import numpy as np

    from single_algebra_tpu_torch import de

    Xl, Xl64, labels = sc["Xl"], sc["Xl64"], sc["labels"]
    n, p = Xl.shape
    dev = torch.device(DEVICE)
    steps, checks, failed = {}, {}, []

    def step(name, fn):
        out, steps[name] = _synced(torch, fn)
        return out

    def bar(name, ok, **fields):
        checks[name] = dict(ok=bool(ok), **fields)
        if not ok:
            failed.append(name)

    names, codes = Xl._batch_codes(list(labels), n, "row")
    G = len(names)
    sizes64 = np.bincount(codes, minlength=G).astype(np.float64)
    torch.cuda.reset_peak_memory_stats()

    # float64 truths: grouped sums, sums of squares and expressing counts
    t0 = time.perf_counter()
    rows_t, cols_t, v64 = _entries_on_card(torch, Xl64)
    key = cols_t * G + torch.from_numpy(codes).to(dev)[rows_t]
    del rows_t
    sums = torch.zeros(p * G, dtype=torch.float64, device=dev).index_add_(0, key, v64)
    sumsq = torch.zeros(p * G, dtype=torch.float64, device=dev).index_add_(0, key, v64 * v64)
    cnt = torch.zeros(p * G, dtype=torch.float64, device=dev).index_add_(
        0, key, torch.ones_like(v64))  # stored entries, as pts counts them
    sums, sumsq, cnt = (t.view(p, G).cpu().numpy() for t in (sums, sumsq, cnt))
    del key, v64, cols_t
    truth_s = time.perf_counter() - t0

    # grouped moments
    sizes, mean, var = step("moments", lambda: de._full_moments(Xl, codes, G))
    single = dict(moments=(sizes, mean, var))  # what the mesh_pipeline phase is held to
    mean64 = sums / sizes64[None, :]
    var64 = np.maximum((sumsq - sums * mean64) / np.maximum(sizes64 - 1, 1)[None, :], 0.0)
    m_err = float(np.abs(mean - mean64).max() / np.abs(mean64).max())
    v_err = float(np.abs(var - var64).max() / np.abs(var64).max())
    bar("moments", m_err <= DE_MOMENT_FAIL and v_err <= DE_MOMENT_FAIL
        and np.array_equal(sizes, sizes64), mean_rel_err=m_err, var_rel_err=v_err,
        fail_above=DE_MOMENT_FAIL, truth_s=truth_s)

    # t-tests: scores per gene, the top 5 away from ties, pts exact
    for method in ("t-test", "t-test_overestim_var"):
        res = step(method, lambda: de.rank_genes_groups(Xl, labels, method=method, pts=True))
        t_err, top_checked, top_off, pts_ok = 0.0, 0, 0, True
        for i, g in enumerate(names):
            t64 = _rest_t64(sums, sumsq, sizes64, i, method == "t-test_overestim_var")
            scale = float(np.abs(t64).max())
            t_err = max(t_err, float(np.abs(_by_gene(res, g) - t64).max() / scale))
            order = np.argsort(-t64, kind="stable")
            if t64[order[DE_TOP - 1]] - t64[order[DE_TOP]] > DE_T_FAIL * scale:
                top_checked += 1
                top_off += set(res.names[g][:DE_TOP].tolist()) != set(order[:DE_TOP].tolist())
            frac_in = cnt[:, i] / sizes64[i]
            frac_out = (cnt.sum(axis=1) - cnt[:, i]) / (n - sizes64[i])
            pts_ok &= (np.array_equal(_by_gene(res, g, "pts"), frac_in)
                       and np.array_equal(_by_gene(res, g, "pts_rest"), frac_out))
        bar(method, t_err <= DE_T_FAIL and top_off == 0 and pts_ok, t_rel_err=t_err,
            fail_above=DE_T_FAIL, top5_groups_checked=top_checked, top5_mismatches=top_off,
            pts_exact=bool(pts_ok))
        single[method] = res
        del res

    # wilcoxon: the whole ranking, then z of 64 seeded genes against
    # float64 tie-averaged ranks on the card
    mc = Xl._layout_for("col")
    W = mc.ell_width
    block = de._wilcoxon_block(W)
    res = step("wilcoxon", lambda: de.rank_genes_groups(Xl, labels, method="wilcoxon"))
    genes = np.sort(np.random.default_rng(12).choice(p, DE_Z_GENES, replace=False))
    t0 = time.perf_counter()
    sub = Xl64[:, genes].tocsc()
    dense = torch.zeros((DE_Z_GENES, n), dtype=torch.float64, device=dev)
    for j in range(DE_Z_GENES):
        lo, hi = sub.indptr[j], sub.indptr[j + 1]
        dense[j, torch.from_numpy(sub.indices[lo:hi].astype(np.int64)).to(dev)] = \
            torch.from_numpy(sub.data[lo:hi]).to(dev)
    ranks, ties = _ranks64(torch, dense)
    del dense
    codes_t = torch.from_numpy(codes).to(dev)
    rsum = torch.zeros((DE_Z_GENES, G), dtype=torch.float64, device=dev).index_add_(
        1, codes_t, ranks).cpu().numpy()
    del ranks
    ties = ties.cpu().numpy()
    n1 = sizes64[None, :]
    sd = np.sqrt(n1 * (n - n1) / 12.0 * ((n + 1.0) - ties[:, None] / (n * (n - 1.0))))
    z64 = (rsum - n1 * (n + 1.0) / 2.0) / sd
    z_truth_s = time.perf_counter() - t0
    zp = np.stack([_by_gene(res, g)[genes] for g in names], axis=1)
    z_err = float((np.abs(zp - z64) / np.maximum(1.0, np.abs(z64))).max())
    # the JAX package's arithmetic (rank sums in the matrix dtype) on the
    # same genes, for the record
    mask, cmap, outcols = de._wilcoxon_plans(codes, list(range(G)), None, G)[0]
    args = (torch.as_tensor(mask, device=dev), torch.as_tensor(cmap, device=dev),
            torch.as_tensor(sizes64, device=dev), n, len(outcols))
    gi = torch.from_numpy(genes).to(dev)
    rs32, tt32 = de._rank_block_sparse(mc.ell_data[gi], mc.ell_ids[gi], mc.row_nnz[gi], *args,
                                       acc=torch.float32)
    sd32 = np.sqrt(n1 * (n - n1) / 12.0 * ((n + 1.0) - tt32.double().cpu().numpy()[:, None]
                                           / (n * (n - 1.0))))
    z32 = (rs32.double().cpu().numpy() - n1 * (n + 1.0) / 2.0) / sd32
    z32_err = float((np.abs(z32 - z64) / np.maximum(1.0, np.abs(z64))).max())
    del rs32, tt32
    first = [de._rank_block_sparse(mc.ell_data[:block], mc.ell_ids[:block], mc.row_nnz[:block],
                                   *args) for _ in range(2)]
    repeat_equal = all(bool(torch.equal(a, b)) for a, b in zip(*first))
    del first, res
    bar("wilcoxon", z_err <= DE_Z_FAIL and repeat_equal, z_rel_err=z_err, fail_above=DE_Z_FAIL,
        genes=DE_Z_GENES, groups=G, truth_s=z_truth_s, block_bit_identical=repeat_equal,
        z_rel_err_float32_rank_sums=z32_err, W=int(W), block=int(block),
        blocks=-(-p // block))

    # logreg on the first rows, against float64 Nesterov steps from the same start
    r = DE_LOGREG_ROWS
    sub_m = Xl.select_rows(np.arange(r))
    sub_labels = labels[:r]
    res = step("logreg", lambda: de.rank_genes_groups(sub_m, sub_labels, method="logreg"))
    t0 = time.perf_counter()
    sub_names, sub_codes = sub_m._batch_codes(list(sub_labels), r, "row")
    Gs = len(sub_names)
    X64 = Xl64[:r].tocsr()
    A, At = csr_on_card(torch, X64, torch.float64), csr_on_card(torch, X64.T, torch.float64)
    Y = torch.nn.functional.one_hot(torch.from_numpy(sub_codes).to(dev), Gs).double()
    Wt = de._logreg_w0(p, Gs, 0, dev).double()
    b = torch.zeros(Gs, dtype=torch.float64, device=dev)
    vW, vb = torch.zeros_like(Wt), torch.zeros_like(b)
    for _ in range(300):
        Wq, bq = Wt + 0.9 * vW, b + 0.9 * vb
        logits = A @ Wq + bq[None, :]
        P = torch.softmax(logits, dim=1)
        D = (P - Y) / r
        gW, gb = At @ D + 1e-4 * Wq, D.sum(dim=0)
        vW, vb = 0.9 * vW - gW, 0.9 * vb - gb
        Wt, b = Wt + vW, b + vb
    W64 = Wt.cpu().numpy()
    del A, At, Y, Wt, vW, P, D
    logreg_truth_s = time.perf_counter() - t0
    Wp = np.stack([_by_gene(res, g) for g in sub_names], axis=1)
    w_err = float(np.abs(Wp - W64).max() / np.abs(W64).max())
    bar("logreg", w_err <= LOGREG_FAIL and np.isnan(res.pvals[sub_names[0]]).all(),
        coef_rel_err=w_err, fail_above=LOGREG_FAIL, rows=r, groups=Gs, steps=300,
        truth_s=logreg_truth_s)
    del res, sub_m
    torch.cuda.empty_cache()
    emit("de", n=n, p=p, groups=G, steps_s=steps, checks=checks,
         peak_alloc_gb=torch.cuda.max_memory_allocated() / 1e9, card=card())
    if failed:
        raise AssertionError(f"de: bars not met: {failed}")
    return single


def phase_metrics_scrna(torch, sc: dict) -> None:
    """``metrics`` on cell 13's outputs: ``silhouette_score`` of 5,000
    sampled rows of the masked PCA scores against the Leiden labels
    (within 1e-5 of the float64 ``silhouette_on_card``); ``morans_i`` /
    ``gearys_c`` of the first 64 HVG columns over the connectivities
    (within 1e-5 of the largest float64 value); ``embedding_density`` of
    the UMAP layout within the Leiden groups (whole groups of at most
    20,000 cells recomputed in float64: 1e-5)."""

    import numpy as np

    from single_algebra_tpu_torch import metrics

    E, labels, S, Y, Xl64 = sc["E"], sc["labels"], sc["S"], sc["Y"], sc["Xl64"]
    n = E.shape[0]
    dev = torch.device(DEVICE)
    steps, checks, failed = {}, {}, []

    def step(name, fn):
        out, steps[name] = _synced(torch, fn)
        return out

    def bar(name, ok, **fields):
        checks[name] = dict(ok=bool(ok), **fields)
        if not ok:
            failed.append(name)

    idx = np.random.default_rng(0).choice(n, METRIC_SIL_ROWS, replace=False)
    it = torch.from_numpy(idx).to(dev)
    sil = step("silhouette_score", lambda: metrics.silhouette_score(E[it], labels[idx]))
    sil64 = silhouette_on_card(torch, E, labels, METRIC_SIL_ROWS, seed=0)
    bar("silhouette", abs(sil - sil64) <= METRIC_FAIL, silhouette=sil, silhouette_f64=sil64,
        fail_above=METRIC_FAIL, rows=METRIC_SIL_ROWS)

    cols = np.where(sc["hvg_mask"])[0][:MORAN_COLS]
    vals = Xl64[:, cols].toarray().astype(np.float32)
    Sm = _graph_on_card(S)
    mi = step("morans_i", lambda: metrics.morans_i(Sm, vals))
    gc = step("gearys_c", lambda: metrics.gearys_c(Sm, vals))
    W = csr_on_card(torch, S, torch.float64)
    x = torch.from_numpy(vals).to(dev).double()
    xc = x - x.mean(dim=0, keepdim=True)
    wx = W @ xc
    deg = torch.from_numpy(np.asarray(S.sum(axis=1)).ravel()).to(dev).double()
    w_sum = float(S.sum())
    den = (xc * xc).sum(dim=0)
    num_m = (xc * wx).sum(dim=0)
    mi64 = ((n / w_sum) * num_m / den).cpu().numpy()
    gc64 = (((n - 1.0) / (2.0 * w_sum)) * 2.0 * ((xc * xc * deg[:, None]).sum(dim=0) - num_m)
            / den).cpu().numpy()
    del W, x, xc, wx
    mi_err = float(np.abs(mi - mi64).max() / np.abs(mi64).max())
    gc_err = float(np.abs(gc - gc64).max() / np.abs(gc64).max())
    bar("autocorrelation", mi_err <= METRIC_FAIL and gc_err <= METRIC_FAIL,
        morans_i_rel_err=mi_err, gearys_c_rel_err=gc_err, fail_above=METRIC_FAIL,
        columns=len(cols), morans_i_range=[float(mi.min()), float(mi.max())])

    dens = step("embedding_density", lambda: metrics.embedding_density(Y, groups=labels))
    groups, counts = np.unique(labels, return_counts=True)
    small = groups[(counts >= 2) & (counts <= DENSITY_GROUP_ROWS)][:3]
    d_err = 0.0
    for g in small:
        sel = np.where(labels == g)[0]
        Yg = Y[torch.from_numpy(sel).to(dev)].double()
        m_ = len(sel)
        h = float(m_ ** (-1.0 / 6.0) * np.std(Yg.cpu().numpy()))
        sq = (Yg * Yg).sum(dim=1)
        kde = torch.exp(-(sq[:, None] + sq[None, :] - 2.0 * (Yg @ Yg.T)).clamp_(min=0.0)
                        / (2.0 * h * h)).mean(dim=1).cpu().numpy()
        scaled = (kde - kde.min()) / (kde.max() - kde.min())
        d_err = max(d_err, float(np.abs(dens[sel] - scaled).max()))
    bar("embedding_density", d_err <= METRIC_FAIL and bool(np.isfinite(dens).all()),
        max_abs_err=d_err, fail_above=METRIC_FAIL, groups_checked=[int(g) for g in small],
        groups=len(groups))
    emit("metrics", case="scrna", n=n, steps_s=steps, checks=checks, card=card())
    if failed:
        raise AssertionError(f"metrics (scrna): bars not met: {failed}")


def _graph_on_card(S):
    """A scipy graph as the port's float32 matrix on the card."""

    import numpy as np

    from single_algebra_tpu_torch import SparseMatrix

    return SparseMatrix.from_scipy(S.astype(np.float32), device=DEVICE)


def _lisi64(torch, X, labels, rows, perplexity: float):
    """Float64 LISI of the sampled ``rows``: exact kNN (k = 3 perplexity,
    self excluded) over all of X, a 100-step bisection of each row's
    Gaussian precision to the perplexity, 1 / sum of squared label masses."""

    import numpy as np

    k = int(round(3 * perplexity))
    X64 = X.double()
    sq = (X64 * X64).sum(dim=1)
    q = X64[rows]
    d2 = sq[rows, None] - 2.0 * (q @ X64.T) + sq[None, :]
    d2.scatter_(1, rows[:, None], float("inf"))
    nd, ni = torch.topk(-d2, k, dim=1)
    d2k = (-nd).clamp(min=0.0)
    lo = torch.zeros(len(rows), dtype=torch.float64, device=X.device)
    hi = torch.full_like(lo, 1e6)
    target = np.log(perplexity)
    for _ in range(100):
        beta = (lo + hi) / 2
        w = torch.exp(-(d2k - d2k[:, :1]) * beta[:, None])
        pr = w / w.sum(dim=1, keepdim=True)
        ent = -(pr * torch.log(pr.clamp(min=1e-300))).sum(dim=1)
        hi = torch.where(ent < target, beta, hi)
        lo = torch.where(ent < target, lo, beta)
    lab = torch.from_numpy(np.unique(labels, return_inverse=True)[1]).to(X.device)[ni]
    mass = torch.zeros((len(rows), int(lab.max()) + 1), dtype=torch.float64,
                       device=X.device).scatter_add_(1, lab, pr)
    return (1.0 / (mass * mass).sum(dim=1)).cpu().numpy()


def phase_metrics_blobs(torch, blobs: dict) -> None:
    """``metrics`` on the t-SNE phase's 50,000 blobs: the full silhouette,
    single card and ``mesh=Mesh((cuda:0,) * 4)`` (within 1e-6 of each
    other), and ``silhouette_score`` of 5,000 sampled points within 1e-5
    of the float64 score of the same points; ARI and NMI of the Leiden labels against the
    planted ones (against the smoke's own ``ari`` and a float64 NMI,
    1e-12); ``lisi``, ``kbet`` and ``silhouette_batch`` with seeded mixed
    batches and with batches split in space inside each blob, against
    float64 recomputes: LISI of 1,000 sampled rows (5e-3 of the largest:
    the float32 kNN parts from float64 at near ties of the 90th neighbor),
    kBET's acceptance over all rows from float64 kNN counts (1e-3), the
    batch silhouette over all rows (1e-5)."""

    import numpy as np
    from scipy.stats import chi2

    from single_algebra_tpu_torch import metrics

    x, labels, leiden_labels = blobs["x"], blobs["labels"], blobs["leiden"]
    xt = torch.from_numpy(x).to(DEVICE)
    n = x.shape[0]
    steps, checks, failed = {}, {}, []

    def step(name, fn):
        out, steps[name] = _synced(torch, fn)
        return out

    def bar(name, ok, **fields):
        checks[name] = dict(ok=bool(ok), **fields)
        if not ok:
            failed.append(name)

    single = step("silhouette", lambda: metrics.silhouette_samples(xt, labels))
    mesh = card_mesh(torch)
    meshed = step("silhouette_mesh", lambda: metrics.silhouette_samples(xt, labels, mesh=mesh))
    mesh_err = float((meshed - single).abs().max() / single.abs().max())
    idx = np.random.default_rng(0).choice(n, SIL_SAMPLE, replace=False)
    s64 = _sil64(torch, xt[torch.from_numpy(idx).to(xt.device)],
                 torch.from_numpy(labels[idx].astype(np.int64)).to(xt.device))
    # the sample's own silhouette score (its clusters are the sampled points)
    sampled = metrics.silhouette_score(x[idx], labels[idx])
    s_err = abs(sampled - float(s64.mean()))
    bar("silhouette", mesh_err <= MESH_SIL_FAIL and s_err <= METRIC_FAIL,
        mesh_rel_err=mesh_err, mesh_fail_above=MESH_SIL_FAIL, sample_score_f64_err=s_err,
        fail_above=METRIC_FAIL, mean=float(single.mean()), entries=mesh.size)

    a_p, a_s = metrics.adjusted_rand_index(leiden_labels, labels), ari(leiden_labels, labels)
    n_p, n_s = metrics.normalized_mutual_info(leiden_labels, labels), nmi64(leiden_labels, labels)
    bar("ari_nmi", abs(a_p - a_s) <= 1e-12 and abs(n_p - n_s) <= 1e-12, ari=a_p, ari_smoke=a_s,
        nmi=n_p, nmi_f64=n_s)

    rng = np.random.default_rng(10)
    mixed = rng.integers(0, 2, n)
    split = np.zeros(n, np.int64)
    for c in np.unique(labels):
        sel = labels == c
        split[sel] = x[sel, 0] > np.median(x[sel, 0])
    rows = torch.from_numpy(np.sort(rng.choice(n, METRIC_CHECK_ROWS, replace=False))).to(xt.device)
    x64 = xt.double()
    sq = (x64 * x64).sum(dim=1)
    knn_ids = []
    for r0 in range(0, n, 4096):
        d2 = sq[r0:r0 + 4096, None] - 2.0 * (x64[r0:r0 + 4096] @ x64.T) + sq[None, :]
        ar = torch.arange(r0, min(r0 + 4096, n), device=xt.device)
        d2[ar - r0, ar] = float("inf")
        knn_ids.append(torch.topk(-d2, KBET_K, dim=1).indices)
    knn_ids = torch.cat(knn_ids)
    del x64, sq
    for name, batch in (("mixed", mixed), ("separated", split)):
        li = step(f"lisi_{name}", lambda: metrics.lisi(xt, batch))
        li64 = _lisi64(torch, xt, batch, rows, 30.0)
        l_err = float(np.abs(li[rows.cpu().numpy()] - li64).max() / np.abs(li64).max())
        kb = step(f"kbet_{name}", lambda: metrics.kbet(xt, batch, k=KBET_K))
        codes = torch.from_numpy(batch).to(xt.device)[knn_ids]
        counts = torch.stack([(codes == b).sum(dim=1) for b in (0, 1)], dim=1).double()
        expected = np.bincount(batch, minlength=2) / n * KBET_K
        stat = ((counts.cpu().numpy() - expected) ** 2 / expected).sum(axis=1)
        kb64 = float(np.mean(chi2.sf(stat, df=1) > 0.05))
        sb = step(f"silhouette_batch_{name}", lambda: metrics.silhouette_batch(xt, batch, labels))
        per = []
        for c in np.unique(labels):
            sel = np.where(labels == c)[0]
            s_ = _sil64(torch, xt[torch.from_numpy(sel).to(xt.device)],
                        torch.from_numpy(batch[sel].astype(np.int64)).to(xt.device))
            per.append(float((1.0 - s_.abs()).mean()))
        sb64 = float(np.mean(per))
        bar(f"batch_{name}", l_err <= LISI_FAIL and abs(kb - kb64) <= KBET_FAIL
            and abs(sb - sb64) <= METRIC_FAIL, lisi_mean=float(li.mean()),
            lisi_rel_err=l_err, lisi_fail_above=LISI_FAIL, kbet=kb, kbet_f64=kb64,
            kbet_fail_above=KBET_FAIL, silhouette_batch=sb, silhouette_batch_f64=sb64,
            fail_above=METRIC_FAIL)
    emit("metrics", case="blobs", n=n, steps_s=steps, checks=checks, card=card())
    if failed:
        raise AssertionError(f"metrics (blobs): bars not met: {failed}")


def phase_analysis_scrna(torch, sc: dict, X) -> None:
    """The analysis surface on cell 13's matrices: ``magic`` on the first
    50,000 rows of the log-normalized matrix, its 2,000 HVGs and its
    masked PCA scores (the densified route), within 1e-5 of max |value|
    of a float64 3-step diffusion on the card over the same graph;
    ``scrublet`` on one 10x lane (20,000 of cell 1's cells with 6 %
    planted doublets across clusters), AUROC at least the bar set from the
    JAX package's CPU run; ``score_genes`` of 50 seeded genes within 1e-6
    of max |score| of float64 masked row sums over the controls its own
    binning draws."""

    import numpy as np
    import scipy.sparse as sp

    from single_algebra_tpu_torch import SparseMatrix, magic, neighbors, score_genes, scrublet
    from single_algebra_tpu_torch.linalg.operators import DensifiedOperator

    Xl, Xl64, E, mask = sc["Xl"], sc["Xl64"], sc["E"], sc["hvg_mask"]
    n, p = Xl.shape
    dev = torch.device(DEVICE)
    steps, checks, failed = {}, {}, []

    def step(name, fn):
        out, steps[name] = _synced(torch, fn)
        return out

    def bar(name, ok, **fields):
        checks[name] = dict(ok=bool(ok), **fields)
        if not ok:
            failed.append(name)

    # magic
    r = MAGIC_ROWS
    cols = np.where(mask)[0]
    Xm = Xl.select_rows(np.arange(r)).select_cols(mask)
    Er = E[:r].contiguous()
    out = step("magic", lambda: magic(Xm, embedding=Er, device_out=True))
    budget = int(DensifiedOperator.hbm_budget_bytes(dev) * 1.2)
    densified = DensifiedOperator.fits((r, r), budget_bytes=budget, needs_lo=True, device=dev)
    t0 = time.perf_counter()
    Wg = neighbors.connectivities(Er, 15).tolil()
    Wg.setdiag(1.0)
    Wg = Wg.tocsr().astype(np.float64)
    M = sp.diags(1.0 / np.asarray(Wg.sum(axis=1)).ravel()) @ Wg
    M64 = csr_on_card(torch, M, torch.float64)
    D = torch.from_numpy(Xl64[:r][:, cols].toarray()).to(dev)
    for _ in range(3):
        D = M64 @ D
    m_err = float((out.double() - D).abs().max() / D.abs().max())
    del M64, D, out
    bar("magic", densified and m_err <= MAGIC_FAIL, rel_err=m_err, fail_above=MAGIC_FAIL,
        rows=r, genes=len(cols), route="densified" if densified else "sparse",
        truth_s=time.perf_counter() - t0)
    del Xm, Er
    torch.cuda.empty_cache()

    # scrublet on a 10x lane with planted doublets
    Xp, is_doublet = planted_doublets(X, SCRUBLET_ROWS, SCRUBLET_RATE, seed=21)
    res = step("scrublet", lambda: scrublet(SparseMatrix.from_scipy(Xp)))
    au = auroc(res.doublet_scores, is_doublet)
    bar("scrublet", au >= SCRUBLET_AUROC_FAIL and bool(np.isfinite(res.doublet_scores).all()),
        auroc=au, fail_below=SCRUBLET_AUROC_FAIL, rows=SCRUBLET_ROWS,
        planted=int(is_doublet.sum()), predicted=int(res.predicted.sum()),
        predicted_planted=int((res.predicted & is_doublet).sum()), threshold=res.threshold)
    del res

    # score_genes: the controls its own binning draws, summed in float64
    genes = np.random.default_rng(8).choice(p, SCORE_GENES, replace=False)
    got = step("score_genes", lambda: score_genes(Xl, genes))
    gene_means = Xl.sum_col().cpu().numpy().astype(np.float64) / n
    order = np.argsort(gene_means, kind="stable")
    ranks = np.empty(p, np.int64)
    ranks[order] = np.arange(p)
    bins = (ranks * 25) // p
    sig = np.unique(genes)
    rng = np.random.default_rng(0)
    ctrl = []
    for b in np.unique(bins[sig]):
        pool = np.where(bins == b)[0]
        pool = pool[~np.isin(pool, sig)]
        if len(pool):
            ctrl.append(rng.choice(pool, size=min(50, len(pool)), replace=False))
    ctrl = np.unique(np.concatenate(ctrl))
    rows_t, cols_t, v64 = _entries_on_card(torch, Xl64)
    truth = torch.zeros(n, dtype=torch.float64, device=dev)
    for sel, sign in ((sig, 1.0 / len(sig)), (ctrl, -1.0 / len(ctrl))):
        hit = torch.zeros(p, dtype=torch.bool, device=dev)
        hit[torch.from_numpy(sel).to(dev)] = True
        keep = hit[cols_t]
        truth.index_add_(0, rows_t[keep], v64[keep] * sign)
    truth = truth.cpu().numpy()
    del rows_t, cols_t, v64
    s_err = float(np.abs(got - truth).max() / np.abs(truth).max())
    bar("score_genes", s_err <= SCORE_FAIL, rel_err=s_err, fail_above=SCORE_FAIL,
        genes=SCORE_GENES, controls=len(ctrl))
    emit("analysis", case="scrna", steps_s=steps, checks=checks, card=card())
    if failed:
        raise AssertionError(f"analysis (scrna): bars not met: {failed}")


def _eig_residual(torch, T, V, lam) -> float:
    """max_j ||T v_j - lam_j v_j|| / ||v_j|| in float64."""

    V = V.double()
    R = T @ V - V * lam[None, :]
    return float((R.norm(dim=0) / V.norm(dim=0)).max())


def phase_analysis_blobs(torch, blobs: dict) -> None:
    """The analysis models on the 50,000 blobs: ``SpectralClustering(10)``
    (ARI >= 0.9; its eigenvectors' float64 residual ||T v - lambda v||
    <= 1e-4), ``diffmap(S, 15, lanczos_steps=1200)`` over the exact
    connectivities (the same residual bar, the first eigenvalue 1 within 1e-5, finite
    ``diffusion_pseudotime``), ``mnn_correct`` of two seeded batches with a
    planted shift (``tests/test_mnn.py``'s bar: the per-blob gap below a
    quarter of the shift, the reference batch untouched, more than 50
    pairs), ``ingest`` of the second half's labels from the first half
    (accuracy >= 0.99)."""

    import numpy as np

    from single_algebra_tpu_torch import ingest
    from single_algebra_tpu_torch.linalg import block_lanczos as bl
    from single_algebra_tpu_torch.models import SpectralClustering, diffmap, diffusion_pseudotime
    from single_algebra_tpu_torch.models import mnn_correct

    x, labels, S = blobs["x"], blobs["labels"], blobs["S"]
    n = x.shape[0]
    xt = torch.from_numpy(x).to(DEVICE)
    steps, checks, failed = {}, {}, []

    def step(name, fn):
        out, steps[name] = _synced(torch, fn)
        return out

    def bar(name, ok, **fields):
        checks[name] = dict(ok=bool(ok), **fields)
        if not ok:
            failed.append(name)

    solves, real = [], bl.block_lanczos_svd
    bl.block_lanczos_svd = lambda *a, **kw: solves.append(real(*a, **kw)) or solves[-1]
    try:
        sc = step("spectral", lambda: SpectralClustering(10).fit(xt))
        dm = step("diffmap", lambda: diffmap(S, 15, lanczos_steps=DIFFMAP_KRYLOV))
    finally:
        bl.block_lanczos_svd = real
    W = sc.affinity_matrix_.to_scipy().astype(np.float64)
    d = np.asarray(W.sum(axis=1)).ravel()
    s = 1.0 / np.sqrt(d)
    T = csr_on_card(torch, W.multiply(s[:, None]).multiply(s[None, :]), torch.float64)
    res = solves[0]
    sc_res = _eig_residual(torch, T, res.u, res.s.double() - 1.0)
    a_s = ari(sc.labels_, labels)
    bar("spectral", a_s >= ARI_FAIL and sc_res <= EIG_RESIDUAL_FAIL, ari=a_s,
        fail_below=ARI_FAIL, eig_residual=sc_res, residual_fail_above=EIG_RESIDUAL_FAIL,
        eigenvalues_top3=(res.s.double() - 1.0)[:3].tolist())
    q = np.asarray(S.sum(axis=1)).ravel().astype(np.float64)
    K = S.astype(np.float64).multiply(1.0 / q[:, None]).multiply(1.0 / q[None, :]).tocsr()
    z = np.asarray(K.sum(axis=1)).ravel()
    T = csr_on_card(torch, K.multiply(1.0 / np.sqrt(z)[:, None])
                    .multiply(1.0 / np.sqrt(z)[None, :]), torch.float64)
    dm_res = _eig_residual(torch, T, torch.from_numpy(dm.embedding).to(DEVICE),
                           torch.from_numpy(dm.eigenvalues).to(DEVICE))
    del T
    dpt = diffusion_pseudotime(dm, 0)
    bar("diffmap", dm_res <= EIG_RESIDUAL_FAIL and abs(dm.eigenvalues[0] - 1.0) <= 1e-5
        and bool(np.isfinite(dpt).all()), eig_residual=dm_res,
        fail_above=EIG_RESIDUAL_FAIL, first_eigenvalue=float(dm.eigenvalues[0]),
        eigenvalues_top3=dm.eigenvalues[:3].tolist())

    rng = np.random.default_rng(9)
    batch = np.where(rng.random(n) < 0.5, "b0", "b1")
    shift = rng.normal(0, 1, x.shape[1])
    shift = (shift / np.linalg.norm(shift) * MNN_SHIFT).astype(np.float32)
    Z = x + (batch == "b1")[:, None] * shift[None, :]
    mres = step("mnn_correct", lambda: mnn_correct(Z, batch, k=15, iterations=3))

    def gap(A):
        return float(np.mean([np.linalg.norm(A[(labels == c) & (batch == "b0")].mean(0)
                                             - A[(labels == c) & (batch == "b1")].mean(0))
                              for c in np.unique(labels)]))

    before, after = gap(Z), gap(mres.corrected)
    ref = batch == mres.batch_order[0]  # batches merge in first-appearance order
    bar("mnn", after < 0.25 * before and mres.n_pairs[0] > 50
        and np.array_equal(mres.corrected[ref], Z[ref]),
        gap_before=before, gap_after=after, pairs=mres.n_pairs,
        reference=mres.batch_order[0])

    half = n // 2
    pred, conf = step("ingest", lambda: ingest(x[:half], x[half:], labels[:half]))
    acc = float(np.mean(pred == labels[half:]))
    bar("ingest", acc >= INGEST_FAIL, accuracy=acc, fail_below=INGEST_FAIL,
        mean_confidence=float(conf.mean()))
    emit("analysis", case="blobs", n=n, steps_s=steps, checks=checks, card=card())
    if failed:
        raise AssertionError(f"analysis (blobs): bars not met: {failed}")


def phase_io(torch, X) -> None:
    """``io`` on one 10x lane (20,000 of cell 1's cells): written as a
    gzipped CellRanger mtx directory (genes x cells, barcodes, features),
    then ``read_10x_mtx`` must give the same CSR on the card. Where
    ``h5py`` imports, also ``write_h5ad`` -> ``read_h5ad`` (the same CSR,
    names and obsm) and ``iter_h5ad_chunks`` (its slabs the same rows);
    else the line says ``"h5py": null``."""

    import gzip
    import shutil

    import numpy as np
    import scipy.io as sio
    import scipy.sparse as sp

    from single_algebra_tpu_torch import io

    Xs = X[:IO_ROWS].tocsr()
    n, p = Xs.shape
    d = os.path.join(ROOT, "build", "smoke_io")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    checks, failed, steps = {}, [], {}

    def bar(name, ok, **fields):
        checks[name] = dict(ok=bool(ok), **fields)
        if not ok:
            failed.append(name)

    def same(a, b):
        a, b = a.tocsr(), b.tocsr()
        a.sort_indices()
        b.sort_indices()
        return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
                and np.array_equal(a.indices, b.indices) and np.array_equal(a.data, b.data))

    try:
        t0 = time.perf_counter()
        with gzip.open(os.path.join(d, "matrix.mtx.gz"), "wb", compresslevel=1) as f:
            sio.mmwrite(f, Xs.T.tocoo(), field="integer")
        with gzip.open(os.path.join(d, "barcodes.tsv.gz"), "wt", compresslevel=1) as f:
            f.writelines(f"CELL{i:07d}-1\n" for i in range(n))
        with gzip.open(os.path.join(d, "features.tsv.gz"), "wt", compresslevel=1) as f:
            f.writelines(f"ENSG{j:011d}\tGENE{j}\tGene Expression\n" for j in range(p))
        steps["write_mtx"] = time.perf_counter() - t0
        ad, steps["read_10x_mtx"] = _synced(torch, lambda: io.read_10x_mtx(d))
        bar("read_10x_mtx", ad.X.device.type == torch.device(DEVICE).type
            and same(ad.X.to_scipy(), Xs)
            and ad.var_names[-1] == f"GENE{p - 1}" and ad.obs_names[0] == "CELL0000000-1",
            shape=list(ad.shape))
        try:
            import h5py  # noqa: F401
        except ImportError:
            h5 = None
        else:
            h5 = True
            path = os.path.join(d, "lane.h5ad")
            emb = np.random.default_rng(0).standard_normal((n, 8)).astype(np.float32)
            _, steps["write_h5ad"] = _synced(torch, lambda: io.write_h5ad(
                path, ad.X, obs_names=ad.obs_names, var_names=ad.var_names,
                obsm={"X_pca": emb}))
            back, steps["read_h5ad"] = _synced(torch, lambda: io.read_h5ad(path))
            chunks = list(io.iter_h5ad_chunks(path, chunk_rows=4096))
            bar("h5ad", same(back.X.to_scipy(), Xs) and same(sp.vstack(chunks), Xs)
                and np.array_equal(back.obsm["X_pca"], emb)
                and np.array_equal(back.var_names, ad.var_names), chunks=len(chunks))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit("io", rows=n, genes=p, nnz=int(Xs.nnz), h5py=h5, steps_s=steps, checks=checks,
         card=card())
    if failed:
        raise AssertionError(f"io: bars not met: {failed}")


def phase_lsi(torch, X, kernel_result: dict) -> dict:
    """``models.lsi(m, 30)`` on cell 2's counts binarized (an ATAC peak
    matrix's values): ``auto`` must take ``TiledSparseOperator``, whose
    TF-IDF payload is split into hi and lo halves; every spmm / rmv launch
    is recorded and, at each shape launched, both kernels are held against
    their plain versions on the engine's hi and lo payloads (1e-5); the
    singular values within 1e-4 (of the largest) of a float64 run of the
    same randomized algorithm with the same sketch over float64 CSR
    products of the float64 TF-IDF. -> the LSI fit's launches and its
    sketch, for the float64 run (``lsi_f64``)."""

    import numpy as np

    from single_algebra_tpu_torch import SparseMatrix
    from single_algebra_tpu_torch.linalg import operators as ops
    from single_algebra_tpu_torch.linalg import svd as svd_mod
    from single_algebra_tpu_torch.linalg.operators import TiledSparseOperator
    from single_algebra_tpu_torch.models import lsi
    from single_algebra_tpu_torch.models import pca as pca_mod
    from single_algebra_tpu_torch.ops import cuda_lib

    Xb = X.copy()
    Xb.data = np.ones_like(Xb.data, dtype=np.float32)
    mb = SparseMatrix.from_scipy(Xb)
    engines, sketches, seen = [], [], set()
    real_engine, real_sketch = pca_mod.make_engine_operator, svd_mod.gaussian_sketch
    originals = {name: getattr(ops, name) for name in ("tiled_ell_spmm_t", "tiled_ell_rmv_t")}

    def spy(name, fn):
        def call(tdata, tlocal, operand, **kw):
            seen.add((name, operand.shape[0], operand.dtype))
            return fn(tdata, tlocal, operand, **kw)
        return call

    pca_mod.make_engine_operator = lambda m_, e: engines.append(real_engine(m_, e)) or engines[-1]
    svd_mod.gaussian_sketch = lambda *a, **kw: sketches.append(real_sketch(*a, **kw)) or sketches[-1]
    for name, fn in originals.items():
        setattr(ops, name, spy(name, fn))
    cuda_lib.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        res, fit_s = _synced(torch, lambda: lsi(mb, LSI_COMPONENTS))
    finally:
        pca_mod.make_engine_operator, svd_mod.gaussian_sketch = real_engine, real_sketch
        for name, fn in originals.items():
            setattr(ops, name, fn)
    launches = {k: cuda_lib.launch_counts[k] for k in ("tiled_ell_spmm_t", "tiled_ell_rmv_t")}
    peak = torch.cuda.max_memory_allocated()
    op = engines[0]
    if not isinstance(op, TiledSparseOperator) or op.tdata_lo is None:
        raise AssertionError(f"lsi's 'auto' built {type(op).__name__} "
                             f"(lo payload: {getattr(op, 'tdata_lo', None) is not None})")
    if min(launches.values()) <= 0:
        raise AssertionError(f"lsi did not launch both tiled kernels: {launches}")
    if res.scores.shape != (X.shape[0], LSI_COMPONENTS) or not np.isfinite(res.scores).all():
        raise AssertionError(f"lsi scores {res.scores.shape}, finite={np.isfinite(res.scores).all()}")
    # every launched shape against the plain versions, on both halves
    wt, ntiles, ct = op.meta[:3]
    gen = torch.Generator(device=op.device)
    gen.manual_seed(15)
    for kp, odt in sorted({(kp, odt) for _, kp, odt in seen}, key=str):
        names = {name for name, k, o in seen if (k, o) == (kp, odt)}
        for half, payload in (("hi", op.tdata), ("lo", op.tdata_lo)):
            if half == "lo" and odt == torch.bfloat16:
                continue  # the fast products read hi alone
            _compare_tiled(torch, kernel_result, gen, f"lsi_{half}_x_{str(odt)[6:]}_kp{kp}",
                           payload, op.tlocal, wt=wt, ntiles=ntiles, ct=ct, kp=kp, odt=odt,
                           spmm="tiled_ell_spmm_t" in names, rmv="tiled_ell_rmv_t" in names)
    emit("lsi", n=X.shape[0], p=X.shape[1], nnz=int(X.nnz), components=LSI_COMPONENTS,
         engine=type(op).__name__, wt=wt, ntiles=ntiles, lo_present=True,
         fit_s=fit_s, launches=launches, shapes_launched=[
             [name, kp, str(odt)] for name, kp, odt in sorted(seen, key=str)],
         peak_alloc_gb=peak / 1e9, engine_build_s=op.build_seconds, card=card())
    del op, engines, mb
    torch.cuda.empty_cache()
    return dict(launches=launches, omega=sketches[0], s=res.singular_values, fit_s=fit_s)


class ScaledPattern64:
    """``diag(f) B diag(g)`` in float64 on the card, B the stored pattern
    (ones) of ``base``'s CSR matrix and its transpose (a ``Csr64Operator``)."""

    def __init__(self, torch, base, f, g):
        def ones(a):
            return torch.sparse_csr_tensor(a.crow_indices(), a.col_indices(),
                                           torch.ones_like(a.values()), size=a.shape)

        self.shape, self.dtype, self.device = base.shape, torch.float64, f.device
        self.b, self.bt, self.f, self.g = ones(base.a), ones(base.at), f, g

    def mv(self, V):
        return self.f[:, None] * (self.b @ (self.g[:, None] * V))

    def rmv(self, C):
        return self.g[:, None] * (self.bt @ (self.f[:, None] * C))


def lsi_f64(torch, ref_op, X, run: dict) -> None:
    """LSI's singular values against a float64 run of the same randomized
    algorithm from the same sketch: the binarized TF-IDF is
    ``diag(f) B diag(g)`` with B the pattern of ``X`` (``ref_op``'s CSR
    structure, ones), f = log1p(1e4 / row count) and g = log1p(n / column
    count), in float64 on the card."""

    import numpy as np

    from single_algebra_tpu_torch.linalg.svd import randomized_svd
    from single_algebra_tpu_torch.types import PowerIterationNormalizer

    n, p = X.shape
    rc = np.diff(X.indptr).astype(np.float64)
    cc = np.bincount(X.indices, minlength=p).astype(np.float64)
    f = torch.from_numpy(np.where(rc > 0, np.log1p(1e4 / np.maximum(rc, 1)), 0.0)).to(DEVICE)
    g = torch.from_numpy(np.where(cc > 0, np.log1p(n / np.maximum(cc, 1)), 0.0)).to(DEVICE)

    t0 = time.perf_counter()
    op = ScaledPattern64(torch, ref_op, f, g)
    t0 = time.perf_counter()
    res = randomized_svd(op, LSI_COMPONENTS + 1, 10, 7, PowerIterationNormalizer.QR,
                         omega=run["omega"].double())
    del op
    s64 = res.s.cpu().numpy()[1:]
    err = float(np.abs(run["s"] - s64).max() / s64[0])
    emit("lsi_ev", sv_rel_err_same_sketch_f64=err, fail_above=LSI_FAIL,
         same_sketch_f64_s=time.perf_counter() - t0, sv_top3=run["s"][:3].tolist(),
         sv_f64_top3=s64[:3].tolist(), card=card())
    if not err <= LSI_FAIL:
        raise AssertionError(f"lsi singular values vs the same-sketch f64 run {err} > {LSI_FAIL}")


def card_mesh(torch):
    """``MESH_ENTRIES`` entries, each naming card 0."""

    from single_algebra_tpu_torch.parallel import Mesh

    return Mesh((torch.device("cuda", 0),) * MESH_ENTRIES)


def _synced(torch, fn):
    """``fn()`` and its seconds on the host clock, the card synchronized."""

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _check_auto(torch, m, mesh, cell: str) -> None:
    """``choose_sharded_engine`` on a mesh of entries sharing one card: the
    engine it chooses must fit ONE card's budget (the dense form of both
    cells does not)."""

    from single_algebra_tpu_torch.linalg.operators import DensifiedOperator
    from single_algebra_tpu_torch.parallel import ShardedTiled, choose_sharded_engine

    n, p = m.shape
    (chosen, choose_s) = _synced(torch, lambda: choose_sharded_engine(m, mesh))
    budget = DensifiedOperator.hbm_budget_bytes(mesh.home)
    need = {"dense": 2 * n * p * (1 if m.values_bf16_exact() else 2),
            "tiled": ShardedTiled.payload_bytes(m, mesh.size)}.get(chosen, 0)
    emit("mesh", case="auto", cell=cell, n=n, p=p, chosen=chosen, payload_bytes=need,
         one_card_budget_bytes=budget, dense_bf16_bytes=2 * n * p, choose_s=choose_s,
         card=card())
    if need > budget:
        raise AssertionError(f"mesh auto on {cell} chose {chosen!r} ({need} bytes) past one "
                             f"card's budget {budget}")


def phase_mesh_cell1(torch, X, single: dict, ev_true, held_widths) -> int:
    """Cell 12 on cell 1's counts: ``sharded_gram_pca`` cold and warm
    (EV vs the float64 truth, 1e-5, and vs the single-card Gram fit, 1e-6
    of the largest; the first 1,000 score rows vs the single card's, 1e-5
    of max |score|; densify launches = 2 x the sub-slabs at held widths),
    then the gather engine's ``lanczos_block(8)`` (EV vs the float64
    uncentered truth, 1e-5), then ``auto``. -> the densify launches of the
    cold Gram fit."""

    import numpy as np

    from single_algebra_tpu_torch import SparseMatrix
    from single_algebra_tpu_torch.ops import cuda_lib
    from single_algebra_tpu_torch.parallel import (
        ShardedSpMM, sharded_gram_pca, sharded_pca_fit_transform,
    )
    from single_algebra_tpu_torch.parallel.sharded import _psum
    from single_algebra_tpu_torch.types import SVDMethod

    mesh = card_mesh(torch)
    emit("mesh", case="setup", entries=mesh.size, distinct_devices=len(mesh.distinct),
         devices=[str(d) for d in mesh.devices], card=card(),
         note="every entry names the one card: each slab's kernels and every reduction "
              "run on it, and no transfer between cards is measured")
    n, p = X.shape
    m = SparseMatrix.from_scipy(X, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    res, cold_s = _synced(torch, lambda: sharded_gram_pca(m, mesh, n_components=K))
    launches = cuda_lib.launch_counts["tiled_ell_densify_t"]
    by_dtype = dict(cuda_lib.densify_launches_by_dtype)
    peak = torch.cuda.max_memory_allocated()
    op = m._operator_cache[("sharded", "gram", mesh)]
    res2, warm_s = _synced(torch, lambda: sharded_gram_pca(m, mesh, n_components=K))
    sub = sum(rc // slab for _, rc, slab in op.bwidths)  # sub-slabs per entry
    widths = sorted({c for c, _, _ in op.bwidths})
    local_ms = _time_ms(torch, lambda: op._local_gram(0), 1)
    G = op.gram_cached()
    psum_ms = _time_ms(torch, lambda: _psum([G] * mesh.size, mesh.home), 3)
    ev = res.explained_variance.double().cpu().numpy()
    err_truth, err_single = _ev_rel_err(ev, ev_true), _ev_rel_err(ev, single["ev"])
    T = res.transformed[:MESH_SCORE_ROWS].double()
    Ts = single["T_head"].double()
    score_err = float((T - Ts).abs().max() / Ts.abs().max())
    warm_same = bool(torch.equal(res.transformed, res2.transformed))
    finite = bool(torch.isfinite(res.transformed).all())
    emit("mesh", case="gram", n=n, p=p, k=K, entries=mesh.size, engine="ShardedGram",
         col_tile=op.meta[1], gram_tier="int8" if op.meta[3] else (
             "bf16" if op.meta[2] else "f32"),
         buckets=[list(b) for b in op.bwidths], cold_s=cold_s, warm_s=warm_s,
         warm_equals_cold=warm_same, per_slab_gram_ms=local_ms, psum_ms=psum_ms,
         peak_alloc_gb=peak / 1e9, densify_launches=launches, densify_launches_by_dtype=by_dtype,
         densify_launches_want=2 * mesh.size * sub, widths=widths, held_widths=held_widths,
         ev_rel_err_f64_truth=err_truth, ev_fail_above=EV_FAIL, ev_target=EV_TARGET,
         ev_rel_err_single_card=err_single, single_fail_above=MESH_SINGLE_FAIL,
         score_rel_err_single_card=score_err, score_rows=MESH_SCORE_ROWS,
         score_fail_above=SCORE_REL_FAIL, card=card())
    del res, res2, G, T, op
    m._operator_cache.clear()
    torch.cuda.empty_cache()
    if launches != 2 * mesh.size * sub or not set(widths) <= set(held_widths):
        raise AssertionError(f"mesh Gram densify launches {launches} (want {2 * mesh.size * sub})"
                             f" at widths {widths}: the kernel phase held {held_widths}")
    if not (finite and err_truth <= EV_FAIL and err_single <= MESH_SINGLE_FAIL
            and score_err <= SCORE_REL_FAIL):
        raise AssertionError(f"mesh Gram fit: EV {err_truth} vs truth, {err_single} vs the "
                             f"single card, scores {score_err}, finite {finite}")

    # the gather engine, block Lanczos, against the uncentered truth
    spop, build_s = _synced(torch, lambda: ShardedSpMM.from_matrix(m, mesh))
    m._operator_cache[("sharded", "sparse", mesh)] = spop
    cuda_lib.reset_launch_counts()
    res, fit_s = _synced(torch, lambda: sharded_pca_fit_transform(
        m, K, mesh=mesh, svd_method=SVDMethod.lanczos(), engine="sparse", lanczos_block=8))
    err = _ev_rel_err(res.explained_variance.double().cpu().numpy(), single["ev_raw"])
    finite = bool(torch.isfinite(res.transformed).all()) and tuple(res.transformed.shape) == (n, K)
    emit("mesh", case="sparse", n=n, p=p, engine="ShardedSpMM", method="lanczos_block(8)",
         build_s=build_s, fit_transform_s=fit_s, row_ell_width=spop.slabs[0].row_data.shape[1],
         col_ell_width=spop.slabs[0].col_data.shape[1],
         kernel_launches=dict(cuda_lib.launch_counts),
         ev_rel_err_f64_truth_uncentered=err, fail_above=EV_FAIL, card=card())
    del res, spop
    m._operator_cache.clear()
    torch.cuda.empty_cache()
    if not (finite and err <= EV_FAIL):
        raise AssertionError(f"mesh gather engine EV rel err {err} > {EV_FAIL} (finite {finite})")
    _check_auto(torch, m, mesh, "1")
    return launches


def phase_mesh_streaming(torch, X, single: dict, held_widths) -> int:
    """Cell 12's stream, over cell 10's first ``MESH_STREAM_CHUNKS`` chunks
    (the smoke's time budget): ``StreamingSparsePCA(mesh=)`` fit and
    transform beside a single-card stream over the same chunks. Bars: EV
    within 1e-6 (of the largest) of that single-card stream, the first
    chunk's scores within 1e-5 of max |score|, densify launches = slabs
    (bf16) + slabs (float32) at held widths; the idle share of one
    ``partial_fit``. -> its densify launches."""

    import numpy as np

    from single_algebra_tpu_torch.models import StreamingSparsePCA
    from single_algebra_tpu_torch.models import streaming_pca as smod
    from single_algebra_tpu_torch.ops import cuda_lib

    mesh = card_mesh(torch)
    p = X.shape[1]
    chunks = [X[r0:r0 + STREAM_CHUNK]
              for r0 in range(0, STREAM_CHUNK * MESH_STREAM_CHUNKS, STREAM_CHUNK)]
    n = sum(c.shape[0] for c in chunks)
    slabs = sum(-(-c.shape[0] // smod._SLAB) for c in chunks)
    widths: dict = {}
    payload = smod._slab_payload

    def recording(*args, **kwargs):
        out = payload(*args, **kwargs)
        widths[out[2]] = widths.get(out[2], 0) + 1
        return out

    def stream(**where):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pca = StreamingSparsePCA(n_components=K, n_features=p, **where)
        for c in chunks:
            pca.partial_fit(c)
        pca.finalize()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = dict(cuda_lib.densify_launches_by_dtype)
        t0 = time.perf_counter()
        scores = [pca.transform(c) for c in chunks]
        torch.cuda.synchronize()
        return pca, scores, fit_s, time.perf_counter() - t0, fit_launches

    ref, ref_scores, ref_fit_s, ref_transform_s, _ = stream(device=DEVICE)
    smod._slab_payload = recording
    try:
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        pca, scores, fit_s, transform_s, fit_launches = stream(mesh=mesh)
        launches = cuda_lib.launch_counts["tiled_ell_densify_t"]
        by_dtype = dict(cuda_lib.densify_launches_by_dtype)
        peak = torch.cuda.max_memory_allocated()
    finally:
        smod._slab_payload = payload
    ev = np.asarray(pca.explained_variance_, np.float64)
    ev_ref = np.asarray(ref.explained_variance_, np.float64)
    ev_err = _ev_rel_err(ev, ev_ref)
    signs = np.sign((pca.components_.float() * ref.components_.float()).sum(dim=1).cpu().numpy())
    score_err = float(np.abs(scores[0] * signs[None, :] - ref_scores[0]).max()
                      / np.abs(ref_scores[0]).max())
    rows_ok = sum(len(t) for t in scores) == n and all(np.isfinite(t).all() for t in scores)
    del pca, scores, ref, ref_scores
    torch.cuda.empty_cache()
    spare = StreamingSparsePCA(n_components=K, n_features=p, mesh=mesh)
    idle = device_idle(torch, lambda: spare.partial_fit(chunks[0]))
    del spare
    torch.cuda.empty_cache()
    emit("mesh", case="streaming", n=n, p=p, chunk_rows=STREAM_CHUNK, chunks=len(chunks),
         slabs=slabs, entries=mesh.size, fit_s=fit_s, transform_s=transform_s,
         single_card_same_chunks_fit_s=ref_fit_s,
         single_card_same_chunks_transform_s=ref_transform_s,
         single_card_all_chunks_fit_s=single["fit_s"],
         partial_fit_idle=idle, single_card_partial_fit_idle=single["idle"],
         peak_alloc_gb=peak / 1e9, densify_launches=launches, densify_launches_fit=fit_launches,
         densify_launches_by_dtype=by_dtype, slab_widths=dict(sorted(widths.items())),
         held_widths=held_widths, ev_rel_err_single_card=ev_err,
         ev_fail_above=MESH_SINGLE_FAIL, score_rel_err_single_card=score_err,
         score_fail_above=SCORE_REL_FAIL, card=card())
    want = {"bfloat16": slabs, "float32": slabs}
    if fit_launches != {"bfloat16": slabs} or by_dtype != want:
        raise AssertionError(f"mesh stream densify launches {by_dtype} (fit {fit_launches}): "
                             f"want {want}")
    unheld = set(widths) - set(held_widths)
    if unheld:
        raise AssertionError(f"mesh stream slab widths {sorted(unheld)}: the kernel phase "
                             f"held {held_widths} only")
    if not (rows_ok and ev_err <= MESH_SINGLE_FAIL and score_err <= SCORE_REL_FAIL):
        raise AssertionError(f"mesh stream: EV {ev_err} vs the single card, scores "
                             f"{score_err}, rows whole and finite {rows_ok}")
    return launches


def phase_mesh_dense(torch, X) -> dict:
    """Cell 12 on cell 3's matrix: ``sharded_pca_fit_transform`` with the
    builder's defaults (Lanczos, tolerance 1e-6) on ``ShardedDensified``,
    cold and warm; its steps counted as the warm fit's ``rmv_precise``
    calls. -> the EVs and times (the caller holds them to its float64
    uncentered truth)."""

    import numpy as np

    from single_algebra_tpu_torch import SparseMatrix
    from single_algebra_tpu_torch.parallel import sharded_pca_fit_transform
    from single_algebra_tpu_torch.types import SVDMethod

    mesh = card_mesh(torch)
    m = SparseMatrix.from_scipy(X, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    def fit():
        return sharded_pca_fit_transform(m, K, mesh=mesh, svd_method=SVDMethod.lanczos(),
                                          engine="dense")

    res, cold_s = _synced(torch, fit)
    peak = torch.cuda.max_memory_allocated()
    op = m._operator_cache[("sharded", "dense", mesh)]
    calls = [0]
    rmv_precise = op.rmv_precise

    def counting(C):
        calls[0] += 1
        return rmv_precise(C)

    op.rmv_precise = counting
    res2, warm_s = _synced(torch, fit)
    del op.rmv_precise  # the counter refers to the operator: no cycle outlives the phase
    ok = (tuple(res.transformed.shape) == (m.shape[0], K)
          and bool(torch.isfinite(res.transformed).all()))
    out = dict(ev=res2.explained_variance.double().cpu().numpy(), cold_s=cold_s, warm_s=warm_s,
               steps=calls[0], peak_alloc_gb=peak / 1e9, lo_present=op.slabs[0].lo is not None,
               scores_ok=ok)
    del res, res2, op
    m._operator_cache.clear()
    del m
    torch.cuda.empty_cache()
    return out


def phase_mesh_tiled(torch, m, ev_single, lanczos_single: dict, kernel_result: dict) -> dict:
    """Cell 12 on cell 2's matrix: ``ShardedTiled`` built, both kernels
    held against their plain versions on slab 0's payload at the path's
    operand shapes, then the randomized fit at the tiled phase's seed (the
    single-card fit's sketch) and ``lanczos_block(8)``, each EV within
    1e-5 of the single-card fit's; launches as predicted from the slab
    count, and none at a shape that was not held; ms per product; then
    ``auto``. -> the kernels' launches in these fits."""

    import numpy as np

    from single_algebra_tpu_torch.linalg import operators as ops
    from single_algebra_tpu_torch.ops import cuda_lib
    from single_algebra_tpu_torch.parallel import ShardedTiled, sharded_pca_fit_transform
    from single_algebra_tpu_torch.types import PowerIterationNormalizer, SVDMethod

    mesh = card_mesh(torch)
    n, p = m.shape
    op, build_s = _synced(torch, lambda: ShardedTiled.from_matrix(m, mesh))
    m._operator_cache[("sharded", "tiled", mesh)] = op
    wt, nt, ct = op.meta[:3]
    slab = op.slabs[0]
    gen = torch.Generator(device=mesh.home)
    gen.manual_seed(14)
    held = set()
    for case, odt, kp, rmv in (("mesh_slab_bf16_x_bf16", torch.bfloat16, 64, True),
                               ("mesh_slab_bf16_x_f32", torch.float32, 64, True),
                               ("mesh_slab_bf16_x_f32_kp56", torch.float32, 56, False),
                               ("mesh_slab_bf16_x_f32_kp8", torch.float32, 8, True)):
        _compare_tiled(torch, kernel_result, gen, case, slab.tdata, slab.tlocal, wt=wt,
                       ntiles=nt, ct=ct, kp=kp, odt=odt, rmv=rmv)
        for name in ("tiled_ell_spmm_t", "tiled_ell_rmv_t")[:2 if rmv else 1]:
            held.add((name, slab.tdata.shape[1], kp, slab.tdata.dtype, odt))
    # the library yardsticks at a slab's rows (cuSPARSE through torch's CSR)
    import scipy.sparse as sp

    rs = op.rows_per_shard
    ip = m._h_indptr
    slab_csr = sp.csr_matrix((m._h_data[:ip[rs]], m._h_indices[:ip[rs]], ip[:rs + 1]),
                             shape=(rs, p))
    lib_gen = torch.Generator(device="cuda")
    lib_gen.manual_seed(6)
    lib_ms = {}
    for name, M, width in (("tiled_ell_spmm_t", slab_csr, p),
                           ("tiled_ell_rmv_t", slab_csr.T.tocsr(), rs)):
        A = csr_on_card(torch, M, torch.float32)
        Dk = torch.randn((width, 64), generator=lib_gen, device="cuda")
        lib_ms[name] = _time_ms(torch, lambda: A @ Dk, 3)
        del A, Dk
    emit("mesh", case="library_slab", rows=rs, kp=64, call="float32 CSR @ dense",
         library_ms=lib_ms, card=card())
    del slab_csr
    if slab.tdata_lo is not None:
        raise AssertionError("cell 2's counts are bf16-exact: a lo payload was not expected")

    seen = set()
    originals = {name: getattr(ops, name) for name in ("tiled_ell_spmm_t", "tiled_ell_rmv_t")}

    def spy(name, fn):
        def call(tdata, tlocal, operand, **kw):
            seen.add((name, tdata.shape[1], operand.shape[0], tdata.dtype, operand.dtype))
            return fn(tdata, tlocal, operand, **kw)
        return call

    runs = {}
    for name, fn in originals.items():
        setattr(ops, name, spy(name, fn))
    try:
        for run_name, kw in (
            ("randomized", dict(svd_method=SVDMethod.random(10, 7, PowerIterationNormalizer.QR))),
            ("randomized_warm",
             dict(svd_method=SVDMethod.random(10, 7, PowerIterationNormalizer.QR))),
            ("lanczos_block_8", dict(svd_method=SVDMethod.lanczos(), lanczos_block=8)),
        ):
            cuda_lib.reset_launch_counts()
            res, seconds = _synced(torch, lambda: sharded_pca_fit_transform(
                m, K, mesh=mesh, engine="tiled", **kw))
            runs[run_name] = dict(
                seconds=seconds, ev=res.explained_variance.double().cpu().numpy(),
                launches={k: cuda_lib.launch_counts[k]
                          for k in ("tiled_ell_spmm_t", "tiled_ell_rmv_t")},
                ok=tuple(res.transformed.shape) == (n, K)
                and bool(torch.isfinite(res.transformed).all()))
            del res
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)

    B = torch.randn((p, K + 10), generator=gen, device=mesh.home)
    C = torch.randn((n, K + 10), generator=gen, device=mesh.home)
    product_ms = {name: _time_ms(torch, lambda f=getattr(op, name), a=arg: f(a), 3)
                  for name, arg in (("mv_fast", B), ("rmv_fast", C), ("mv", B), ("rmv", C))}
    del B, C
    ndev = mesh.size
    rand, block = runs["randomized"], runs["lanczos_block_8"]
    block_steps = block["launches"]["tiled_ell_rmv_t"] // ndev
    predicted = dict(randomized={"tiled_ell_spmm_t": ndev * 9, "tiled_ell_rmv_t": ndev * 8},
                     lanczos_block_8={"tiled_ell_spmm_t": ndev * (block_steps + 1),
                                      "tiled_ell_rmv_t": ndev * block_steps})
    errs = dict(randomized=_ev_rel_err(rand["ev"], ev_single),
                randomized_warm=_ev_rel_err(runs["randomized_warm"]["ev"], ev_single),
                lanczos_block_8=_ev_rel_err(block["ev"], lanczos_single["lanczos_block_8"]["ev"]))
    unheld = sorted(str(s_) for s_ in seen - held)
    emit("mesh", case="tiled", n=n, p=p, entries=ndev, engine="ShardedTiled", wt=wt, ntiles=nt,
         col_tile=ct, rows_per_slab=op.rows_natural, payload_rows_per_slab=op.rows_per_shard,
         ovw=op.meta[4], ovtw=op.meta[5], build_s=build_s,
         fit_transform_s={k: v["seconds"] for k, v in runs.items()},
         single_card_lanczos_block_8_s=lanczos_single["lanczos_block_8"]["seconds"],
         launches={k: v["launches"] for k, v in runs.items()}, launches_predicted=predicted,
         block_steps=block_steps,
         single_card_block_steps=lanczos_single["lanczos_block_8"]["steps"],
         product_ms_kp64=product_ms, shapes_launched=sorted(str(s_) for s_ in seen),
         shapes_not_held=unheld, ev_rel_err_single_card=errs, ev_fail_above=EV_FAIL,
         card=card())
    del op, slab
    m._operator_cache.clear()
    torch.cuda.empty_cache()
    if unheld:
        raise AssertionError(f"mesh tiled kernels launched at shapes not held: {unheld}")
    for run_name, want in predicted.items():
        if runs[run_name]["launches"] != want:
            raise AssertionError(f"mesh tiled {run_name} launches {runs[run_name]['launches']},"
                                 f" predicted {want}")
    if not all(r["ok"] for r in runs.values()) or not max(errs.values()) <= EV_FAIL:
        raise AssertionError(f"mesh tiled fits: EV vs the single card {errs}")
    _check_auto(torch, m, mesh, "2")
    return {k: rand["launches"][k] + block["launches"][k] for k in rand["launches"]}


def phase_mesh_tsne(torch, x, labels, cfg, single_epoch_ms: float) -> None:
    """Cell 12's t-SNE: ``tsne.run(mesh=)`` (knn mode, ``MESH_TSNE_EPOCHS``
    epochs: the smoke's time budget) on the knn phase's blobs: the mesh
    gradient at a seeded y within 1e-4 of max |g| of a float64 evaluation
    and bit for bit on repeat, finite output, a silhouette of at least
    0.7; ms per epoch beside the single card's."""

    import dataclasses

    from single_algebra_tpu_torch.models import tsne

    cfg = dataclasses.replace(cfg, epochs=MESH_TSNE_EPOCHS)

    mesh = card_mesh(torch)
    dev = mesh.home
    n = x.shape[0]
    xt = torch.from_numpy(x).to(dev)
    (src, dst, val), edges_s = _synced(torch, lambda: tsne._knn_edges(xt, cfg))
    lay, layout_s = _synced(torch, lambda: tsne._KnnMesh.build(src, dst, val, n, mesh, cfg,
                                                               xt.dtype))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    y = 10.0 * torch.randn((n, cfg.output_dim), generator=gen, device=dev)
    g1, g2 = tsne._knn_grad_mesh(lay, y, 12.0), tsne._knn_grad_mesh(lay, y, 12.0)
    g64 = tsne._knn_grad_mesh(lay, y.double(), 12.0)
    grad_err = float((g1.double() - g64).abs().max() / g64.abs().max())
    identical = bool(torch.equal(g1, g2))
    grad_ms = _time_ms(torch, lambda: tsne._knn_grad_mesh(lay, y, 12.0), 5)
    del g1, g2, g64, lay
    Y, total_s = _synced(torch, lambda: tsne.run(x, cfg, mesh=mesh))
    finite = bool(torch.isfinite(Y).all())
    sil = silhouette_on_card(torch, Y, labels, SIL_SAMPLE) if finite else float("nan")
    setup_s = edges_s + layout_s
    emit("mesh", case="tsne", mode="knn", n=n, entries=mesh.size, epochs=cfg.epochs,
         total_s=total_s, setup_s=setup_s, epoch_ms=(total_s - setup_s) / cfg.epochs * 1e3,
         single_card_epoch_ms=single_epoch_ms, grad_ms=grad_ms, grad_rel_err_f64=grad_err,
         grad_fail_above=TSNE_GRAD_FAIL, grad_bit_identical=identical, finite=finite,
         silhouette=sil, silhouette_fail_below=SIL_FAIL, card=card())
    if not (grad_err <= TSNE_GRAD_FAIL and identical and finite and sil >= SIL_FAIL):
        raise AssertionError("mesh t-SNE: a bar was not met")


def phase_tracing(torch, m, builder) -> int:
    """``utils.tracing`` around one warm ``fit_transform`` of the main path
    (its Gram engine cached on ``m``): the steps as ``stage``s inside one
    ``profile_trace`` written to ``build/trace/``. -> its densify launches."""

    import glob
    import shutil

    from single_algebra_tpu_torch.models import make_engine_operator
    from single_algebra_tpu_torch.ops import densify
    from single_algebra_tpu_torch.utils.tracing import (
        profile_trace, reset_stage_timings, stage, stage_timings)

    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    os.makedirs(TRACE_DIR)
    names = ("engine", "fit", "transform")
    reset_stage_timings()
    densify.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_trace = time.perf_counter()
    with profile_trace(TRACE_DIR):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with stage("engine"):
            make_engine_operator(m, "auto")
        with stage("fit"):
            pca = builder().build().fit(m)
        with stage("transform"):
            T = pca.transform(m)
        wall = time.perf_counter() - t0  # each stage synchronises the card on exit
    trace_s = time.perf_counter() - t_trace
    launches = densify.launch_counts["tiled_ell_densify_t"]
    st = stage_timings()
    files = glob.glob(os.path.join(TRACE_DIR, "*.pt.trace.json"))
    events = json.load(open(files[0]))["traceEvents"] if len(files) == 1 else []
    ev_names = {e.get("name", "") for e in events}
    kernel_events = sum(1 for e in events
                        if e.get("cat") == "kernel" and "densify_tile_kernel" in e.get("name", ""))
    total = sum(st.values())
    ok = (set(st) == set(names) and set(names) <= ev_names and kernel_events > 0
          and launches > 0 and abs(total - wall) <= TRACE_SUM_FAIL * wall
          and bool(torch.isfinite(T).all()))
    emit("tracing", stages_s=st, stage_sum_s=total, wall_s=wall, with_capture_and_export_s=trace_s,
         sum_vs_wall=(total - wall) / wall, fail_above=TRACE_SUM_FAIL,
         trace_files=[os.path.relpath(f, ROOT) for f in files],
         trace_mb=sum(os.path.getsize(f) for f in files) / 1e6, trace_events=len(events),
         densify_kernel_events=kernel_events, densify_launches=launches,
         stage_names_in_trace=sorted(set(names) & ev_names),
         peak_alloc_gb=torch.cuda.max_memory_allocated() / 1e9, card=card())
    if not ok:
        raise AssertionError("tracing: the trace, the stages or their seconds are off")
    return launches


def _group_means64(torch, Z, lab, G: int):
    """float64 ``[G, d]`` means of the rows of ``Z`` by ``lab`` (host ints)."""

    lab_t = torch.from_numpy(lab).to(Z.device)
    Z = Z.double()
    s = torch.zeros((G, Z.shape[1]), dtype=torch.float64, device=Z.device).index_add_(0, lab_t, Z)
    c = torch.bincount(lab_t, minlength=G).double()
    return s / c[:, None]


def _batch_separation64(torch, Z, types, batch):
    """``tests/test_harmony.py::_batch_separation`` on the card in float64:
    the mean over types of the distance between the two batches'
    centroids, over the global standard deviation of Z."""

    import numpy as np

    G = int(types.max()) + 1
    a = _group_means64(torch, Z, types * 2 + batch.astype(np.int64), 2 * G).view(G, 2, -1)
    gaps = torch.linalg.norm(a[:, 0] - a[:, 1], dim=1)
    return float(gaps.mean() / Z.double().std())


def _correct_float32_systems(torch, Z, R, phi_star, lam: float):
    """Harmony's correction with its ridge systems formed and solved in
    float32, the JAX package's arithmetic (for the record beside the
    port's float64 systems)."""

    n, q = phi_star.shape
    K, d = R.shape[1], Z.shape[1]
    RP = (R[:, :, None] * phi_star[:, None, :]).reshape(n, K * q)
    ridge = torch.ones(q, device=Z.device)
    ridge[0] = 0.0
    A = (RP.T @ phi_star).reshape(K, q, q) + lam * torch.diag(ridge)
    W = torch.linalg.solve(A, (RP.T @ Z).reshape(K, q, d))
    W[:, 0] = 0.0
    return Z - RP @ W.reshape(K * q, d)


def phase_harmony(torch, sc: dict) -> None:
    """Cell 13's masked-PCA scores with two planted batches through
    ``harmony``'s defaults (K 100, sigma 0.1, theta 2). See the module
    docstring (33) for the bars."""

    import importlib

    import numpy as np

    from single_algebra_tpu_torch.models import KMeans, harmony
    from single_algebra_tpu_torch.models import kmeans as kmod

    hm = importlib.import_module("single_algebra_tpu_torch.models.harmony")
    E = sc["E"]
    n, d = E.shape
    dev = E.device
    sizes = np.full(64, n // 64)
    sizes[: n % 64] += 1
    planted = np.repeat(np.arange(64), sizes)
    checks, failed, steps = {}, [], {}

    def bar(name, ok, **fields):
        checks[name] = dict(ok=bool(ok), **fields)
        if not ok:
            failed.append(name)

    rng = np.random.default_rng(21)
    C = _group_means64(torch, E, planted, 64)
    dist = torch.cdist(C, C)
    med = float(dist[torch.triu(torch.ones_like(dist, dtype=torch.bool), 1)].median())
    shift = rng.standard_normal(d)
    shift *= 0.5 * med / np.linalg.norm(shift)
    batch = np.zeros(n, bool)
    batch[rng.permutation(n)[: n // 2]] = True
    Zs = E + torch.from_numpy(batch).to(dev)[:, None] * torch.from_numpy(shift).float().to(dev)
    labels = np.where(batch, "b1", "b0")
    torch.cuda.reset_peak_memory_stats()

    res, steps["harmony"] = _synced(torch, lambda: harmony(Zs, labels))
    again, steps["harmony_repeat"] = _synced(torch, lambda: harmony(Zs, labels))
    Zh = torch.from_numpy(res.embedding).to(dev)
    bar("repeat", np.array_equal(res.embedding, again.embedding)
        and res.objective == again.objective, bit_identical=True)
    del again
    before = _batch_separation64(torch, Zs, planted, batch)
    after = _batch_separation64(torch, Zh, planted, batch)
    bar("mixing", after < HARMONY_SEP_RATIO * before and bool(torch.isfinite(Zh).all()),
        separation_before=before, separation_after=after, fail_above_ratio=HARMONY_SEP_RATIO)
    # structure: Lloyd from the same k-means++ centers on the unshifted and
    # the corrected scores
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    w = torch.ones(n, device=dev)
    C0 = kmod._plusplus_init(gen, E, kmod._row_sq_norms(E), w, 64)
    base = kmod._lloyd(E, kmod._row_sq_norms(E), KMeans(64)._tol2(E), C0, w, k=64, max_iter=300)
    corr = kmod._lloyd(Zh, kmod._row_sq_norms(Zh), KMeans(64)._tol2(Zh), C0, w, k=64,
                       max_iter=300)
    a_base = ari(base[1].cpu().numpy(), planted)
    a_corr = ari(corr[1].cpu().numpy(), planted)
    bar("structure", a_corr >= a_base - HARMONY_ARI_DROP, ari_corrected=a_corr,
        ari_unshifted=a_base, fail_below=a_base - HARMONY_ARI_DROP)
    del base, corr, Zh

    # one sweep and one correction from the same state against float64
    B, codes = hm._batch_codes(labels, n)
    K = min(100, max(2, round(n / 30)))
    Zc = hm._l2n(Zs)
    km = KMeans(n_clusters=K, n_init=1, max_iter=10, random_seed=0, device=dev).fit(Zc)
    Y = hm._l2n(km.cluster_centers_.float())
    phi = torch.nn.functional.one_hot(torch.from_numpy(codes).to(dev), B).float()
    phi_star = torch.cat([torch.ones((n, 1), device=dev), phi], dim=1)
    O0 = torch.ones((B, K), device=dev)
    R = hm._assign_block(Zc, phi, Y, O0, O0, 0.1, 2.0)
    nb = phi.sum(dim=0) / n
    O, Eb = phi.T @ R, torch.outer(nb, R.sum(dim=0))
    blocks = torch.split(torch.from_numpy(np.random.default_rng(0).permutation(n)).to(dev),
                         max(int(np.ceil(n * 0.05)), 1))
    state = (Zc, phi, R, O, Eb, nb)
    out32, steps["sweep"] = _synced(torch, lambda: hm._kmeans_sweep(*state, blocks, 0.1, 2.0))
    out64 = hm._kmeans_sweep(*(t.double() for t in state), blocks, 0.1, 2.0)
    r_err = float((out32[0].double() - out64[0]).abs().max() / out64[0].abs().max())
    z32, steps["correct"] = _synced(torch, lambda: hm._correct(Zs, out64[0].float(), phi_star, 1.0))
    z64 = hm._correct(Zs.double(), out64[0], phi_star.double(), 1.0)
    z_err = float((z32.double() - z64).abs().max() / z64.abs().max())
    zj = _correct_float32_systems(torch, Zs, out64[0].float(), phi_star, 1.0)
    zj_err = float((zj.double() - z64).abs().max() / z64.abs().max())
    bar("one_step_f64", r_err <= HARMONY_STEP_FAIL and z_err <= HARMONY_STEP_FAIL,
        R_rel_err=r_err, Z_rel_err=z_err, fail_above=HARMONY_STEP_FAIL,
        Z_rel_err_float32_systems=zj_err)
    del out32, out64, z32, z64, zj, state, R, phi, phi_star
    torch.cuda.empty_cache()
    emit("harmony", n=n, d=d, K=K, batches=B, shift_norm=float(np.linalg.norm(shift)),
         median_centroid_distance=med, rounds=res.n_rounds, converged=res.converged,
         objective=res.objective, s_per_round=steps["harmony"] / max(res.n_rounds, 1),
         steps_s=steps, checks=checks, peak_alloc_gb=torch.cuda.max_memory_allocated() / 1e9,
         card=card())
    if failed:
        raise AssertionError(f"harmony: bars not met: {failed}")


def phase_mesh_pipeline(torch, m, sc: dict, de_single: dict) -> None:
    """The mesh pipeline stages on cell 1's counts over ``Mesh((cuda:0,) *
    4)``, each held to the single card's ``scrna`` / ``de`` result. See the
    module docstring (34) for the bars."""

    import numpy as np

    from single_algebra_tpu_torch.parallel import (
        ShardedSpMM, mesh_col_moments, mesh_grouped_moments, mesh_highly_variable_genes,
        mesh_log1p, mesh_normalize_total, mesh_qc_metrics, mesh_rank_genes_groups, mesh_scale)

    mesh = card_mesh(torch)
    n, p = m.shape
    steps, checks, failed = {}, {}, []

    def step(name, fn):
        out, steps[name] = _synced(torch, fn)
        return out

    def bar(name, ok, **fields):
        checks[name] = dict(ok=bool(ok), **fields)
        if not ok:
            failed.append(name)

    torch.cuda.reset_peak_memory_stats()
    op = step("sharded_spmm", lambda: ShardedSpMM.from_matrix(m, mesh))
    mito = np.zeros(p, bool)
    mito[::13] = True
    obs, var = step("qc", lambda: mesh_qc_metrics(op, qc_vars={"mito": mito}))
    obs1, var1 = sc["qc"]
    keys = [("obs", k) for k in ("n_genes_by_counts", "total_counts", "total_counts_mito")] + \
        [("var", k) for k in ("n_cells_by_counts", "total_counts")]
    bar("qc", all(np.array_equal((obs if w == "obs" else var)[k], (obs1 if w == "obs" else var1)[k])
                  for w, k in keys), exact=[f"{w}.{k}" for w, k in keys])
    op_n, _ = step("normalize_total", lambda: mesh_normalize_total(op, target_sum=NORM_TARGET))
    del op
    op_l = step("log1p", lambda: mesh_log1p(op_n))
    del op_n
    hvg = step("hvg", lambda: mesh_highly_variable_genes(op_l, n_top_genes=SCRNA_HVG,
                                                          flavor="seurat"))
    h1 = sc["hvg"]
    norm1 = np.asarray(h1.dispersions_norm, np.float64)
    scale = float(np.abs(norm1).max())
    d_err = float(np.abs(np.asarray(hvg.dispersions_norm, np.float64) - norm1).max() / scale)
    cutoff = np.sort(norm1)[::-1][SCRNA_HVG - 1]
    near = np.abs(norm1 - cutoff) <= HVG_FAIL * scale
    off = int(((hvg.mask != h1.mask) & ~near).sum())
    mean_e, _ = mesh_col_moments(op_l, expm1=True)
    mu_err = float(np.abs(mean_e - np.asarray(h1.means, np.float64)).max()
                   / np.abs(np.asarray(h1.means, np.float64)).max())
    bar("hvg", d_err <= HVG_FAIL and off == 0 and mu_err <= MESH_MOMENT_FAIL,
        dispersions_norm_rel_err=d_err, fail_above=HVG_FAIL, mask_mismatch_beyond_cutoff=off,
        genes_near_cutoff=int(near.sum()), means_rel_err=mu_err,
        means_fail_above=MESH_MOMENT_FAIL)
    op_s = step("scale", lambda: mesh_scale(op_l))
    _, var_s = mesh_col_moments(op_s)
    live = var_s > 0
    bar("scale", bool(np.isfinite(var_s).all()),
        unit_variance_max_abs_err=float(np.abs(var_s[live] - 1.0).max()))
    del op_s
    labels = sc["labels"]
    names, codes = m._batch_codes(list(labels), n, "row")
    G = len(names)
    sizes, mean, var_g = step("grouped_moments", lambda: mesh_grouped_moments(op_l, codes, G))
    sizes1, mean1, var1_g = de_single["moments"]
    m_err = float(np.abs(mean - mean1).max() / np.abs(mean1).max())
    v_err = float(np.abs(var_g - var1_g).max() / np.abs(var1_g).max())
    bar("moments", np.array_equal(sizes, sizes1) and max(m_err, v_err) <= MESH_MOMENT_FAIL,
        mean_rel_err=m_err, var_rel_err=v_err, fail_above=MESH_MOMENT_FAIL)
    for method in ("t-test", "t-test_overestim_var"):
        res = step(method, lambda: mesh_rank_genes_groups(op_l, labels, method=method, pts=True))
        ref = de_single[method]
        t_err, pts_ok = 0.0, True
        for g in names:
            t1 = _by_gene(ref, g)
            t_err = max(t_err, float(np.abs(_by_gene(res, g) - t1).max() / np.abs(t1).max()))
            pts_ok &= (np.array_equal(_by_gene(res, g, "pts"), _by_gene(ref, g, "pts"))
                       and np.array_equal(_by_gene(res, g, "pts_rest"),
                                          _by_gene(ref, g, "pts_rest")))
        bar(method, t_err <= MESH_T_FAIL and pts_ok, t_rel_err=t_err, fail_above=MESH_T_FAIL,
            pts_exact=bool(pts_ok))
        del res
    for method in ("wilcoxon", "logreg"):
        try:
            mesh_rank_genes_groups(op_l, labels, method=method)
            refused = False
        except ValueError as e:
            refused = "not supported on the mesh" in str(e)
        bar(f"refuses_{method}", refused)
    del op_l
    torch.cuda.empty_cache()
    emit("mesh_pipeline", n=n, p=p, entries=mesh.size, groups=G, steps_s=steps, checks=checks,
         peak_alloc_gb=torch.cuda.max_memory_allocated() / 1e9, card=card())
    if failed:
        raise AssertionError(f"mesh_pipeline: bars not met: {failed}")


def phase_nmf(torch, m, X) -> int:
    """``NMF(20)`` on the densified path's matrix and payload. See the
    module docstring (35) for the bars. -> the densify launches of the
    gather route's init (a Gram engine)."""

    import importlib

    import numpy as np

    from single_algebra_tpu_torch.linalg.operators import DensifiedOperator
    from single_algebra_tpu_torch.models import NMF
    from single_algebra_tpu_torch.ops import densify

    nm = importlib.import_module("single_algebra_tpu_torch.models.nmf")
    n, p = m.shape
    dev = torch.device(DEVICE)
    steps, checks, failed = {}, {}, []

    def bar(name, ok, **fields):
        checks[name] = dict(ok=bool(ok), **fields)
        if not ok:
            failed.append(name)

    torch.cuda.reset_peak_memory_stats()
    model = NMF(NMF_K)
    W, steps["fit"] = _synced(torch, lambda: model.fit_transform(m))
    op = m._operator_cache.get("dense")
    bar("engine", model.engine_ == "DensifiedOperator" and op is m._operator_cache.get("auto")
        and np.isfinite(W).all() and W.shape == (n, NMF_K) and (W >= 0).all(),
        engine=model.engine_, one_payload=op is m._operator_cache.get("auto"))

    # the first MU iterations from the same start against float64 CSR products
    W0, H0 = model._init_wh(m, torch.float32)
    x_sq = nm._x_sq(m, torch.float32)
    (W32, H32, _, _), steps["mu_f32"] = _synced(
        torch, lambda: nm._mu_loop(op, W0, H0, x_sq, 0.0, NMF_F64_ITERS))
    t0 = time.perf_counter()
    op64 = Csr64Operator(torch, X, DEVICE)
    x_sq64 = torch.tensor(float(np.square(X.data, dtype=np.float64).sum()), dtype=torch.float64,
                          device=dev)
    W64, H64, _, _ = nm._mu_loop(op64, W0.double(), H0.double(), x_sq64, 0.0, NMF_F64_ITERS)
    w_err = float((W32.double() - W64).abs().max() / W64.abs().max())
    h_err = float((H32.double() - H64).abs().max() / H64.abs().max())
    bar("mu_f64", max(w_err, h_err) <= NMF_F64_FAIL, W_rel_err=w_err, H_rel_err=h_err,
        iterations=NMF_F64_ITERS, fail_above=NMF_F64_FAIL, truth_s=time.perf_counter() - t0)
    del W32, H32, W64, H64, W0, H0
    Wt = torch.from_numpy(W).to(dev).double()
    Ht = torch.from_numpy(model.components_).to(dev).double()
    loss64 = x_sq64 - 2.0 * (Wt * op64.mv(Ht.T)).sum() + ((Wt.T @ Wt) * (Ht @ Ht.T)).sum()
    err64 = float(torch.sqrt(torch.clamp(loss64, min=0.0)))
    l_err = abs(model.reconstruction_err_ - err64) / err64
    bar("loss", l_err <= NMF_LOSS_FAIL, reconstruction_err=model.reconstruction_err_,
        reconstruction_err_f64=err64, rel_err=l_err, fail_above=NMF_LOSS_FAIL)
    del op64, Wt, Ht, W
    torch.cuda.empty_cache()

    # the gather route (the dense budget at 0) and the mesh on the first rows
    sub = m.select_rows(np.arange(NMF_SUB_ROWS))
    budget = DensifiedOperator.hbm_budget_bytes
    DensifiedOperator.hbm_budget_bytes = staticmethod(lambda device: 0)
    densify.reset_launch_counts()
    try:
        gather = NMF(NMF_K, max_iter=NMF_SUB_ITER)
        Wg, steps["gather_fit"] = _synced(torch, lambda: gather.fit_transform(sub))
    finally:
        DensifiedOperator.hbm_budget_bytes = budget
    launches = densify.launch_counts["tiled_ell_densify_t"]
    meshed = NMF(NMF_K, max_iter=NMF_SUB_ITER, mesh=card_mesh(torch))
    Wm, steps["mesh_fit"] = _synced(torch, lambda: meshed.fit_transform(sub))
    e_err = abs(meshed.reconstruction_err_ - gather.reconstruction_err_) / gather.reconstruction_err_
    Wg_t, Wm_t = torch.from_numpy(Wg).to(dev), torch.from_numpy(Wm).to(dev)
    Hg_t = torch.from_numpy(gather.components_).to(dev)
    Hm_t = torch.from_numpy(meshed.components_).to(dev)
    num = den = 0.0
    for r0 in range(0, NMF_SUB_ROWS, 5_000):
        Rg = Wg_t[r0:r0 + 5_000] @ Hg_t
        num += float(((Wm_t[r0:r0 + 5_000] @ Hm_t - Rg).double() ** 2).sum())
        den += float((Rg.double() ** 2).sum())
    wh_err = (num / den) ** 0.5
    bar("gather_vs_mesh", gather.engine_ == "SparseOperator" and meshed.engine_ == "ShardedSpMM"
        and e_err <= NMF_ERR_FAIL and wh_err <= NMF_WH_FAIL, err_rel=e_err,
        err_fail_above=NMF_ERR_FAIL, WH_rel=wh_err, WH_fail_above=NMF_WH_FAIL,
        iterations=[gather.n_iter_, meshed.n_iter_], rows=NMF_SUB_ROWS,
        init_densify_launches=launches)
    del sub, Wg_t, Wm_t, Hg_t, Hm_t
    torch.cuda.empty_cache()
    emit("nmf", n=n, p=p, k=NMF_K, n_iter=model.n_iter_, fit_s=steps["fit"],
         ms_per_iteration=steps["mu_f32"] / NMF_F64_ITERS * 1e3,
         gather_fit_s=steps["gather_fit"], mesh_fit_s=steps["mesh_fit"],
         steps_s=steps, checks=checks, peak_alloc_gb=torch.cuda.max_memory_allocated() / 1e9,
         card=card())
    if failed:
        raise AssertionError(f"nmf: bars not met: {failed}")
    return launches


def fa2_separation(y, labels) -> float:
    """``tests/test_draw_graph.py::_separation``: the least distance between
    two label centroids over the mean within-label spread."""

    import numpy as np

    labs = np.unique(labels)
    cents = np.stack([y[labels == c].mean(0) for c in labs])
    within = np.mean([np.linalg.norm(y[labels == c] - cents[i], axis=1).mean()
                      for i, c in enumerate(labs)])
    d = np.linalg.norm(cents[:, None] - cents[None, :], axis=-1)
    return float(d[np.triu_indices_from(d, k=1)].min() / max(within, 1e-9))


def phase_draw_graph(torch, blobs: dict) -> None:
    """ForceAtlas2 on the blobs' 50,000-node graph. See the module
    docstring (36) for the bars."""

    import importlib

    import numpy as np

    from single_algebra_tpu_torch.models import draw_graph

    dg = importlib.import_module("single_algebra_tpu_torch.models.draw_graph")
    S, labels = blobs["S"], blobs["labels"]
    n = S.shape[0]
    dev = torch.device(DEVICE)
    steps, checks, failed = {}, {}, []

    def bar(name, ok, **fields):
        checks[name] = dict(ok=bool(ok), **fields)
        if not ok:
            failed.append(name)

    # the public run, its iterations split at FA2_CHECK_ITER (the same
    # state carried over: the same bits) to keep that state for the checks
    kept, run = {}, dg._fa2_chunk

    def split(state, mass, e_src, e_dst, e_val, i0, i1, *args, **kwargs):
        if i0 < FA2_CHECK_ITER < i1:
            state = run(state, mass, e_src, e_dst, e_val, i0, FA2_CHECK_ITER, *args, **kwargs)
            kept.update(state=state, mass=mass, e_src=e_src, e_dst=e_dst, e_val=e_val)
            i0 = FA2_CHECK_ITER
        return run(state, mass, e_src, e_dst, e_val, i0, i1, *args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    dg._fa2_chunk = split
    try:
        y, steps["draw_graph"] = _synced(torch, lambda: draw_graph(S))
    finally:
        dg._fa2_chunk = run
    sep = fa2_separation(y, labels)
    bar("layout", np.isfinite(y).all() and y.shape == (n, 2) and sep > FA2_SEP_FAIL,
        separation=sep, fail_below=FA2_SEP_FAIL, radius=float(np.abs(y).max()))

    # the forces, float32 against float64, at the seeded start and after 250
    # iterations of the public run
    mass, e_src, e_dst, e_val = (kept[k] for k in ("mass", "e_src", "e_dst", "e_val"))
    lengths = torch.bincount(e_src, minlength=n)
    opts = dict(strong_gravity=False, lin_log=False, outbound=False)
    block = min(2048, max(-(-n // 8) // 128 * 128, 128))

    def forces(yt):
        return dg._forces(yt, mass.to(yt.dtype), e_src, e_dst, e_val.to(yt.dtype), scaling=2.0,
                          gravity=1.0, block=block, lengths=lengths, **opts)

    def force_check(yt):
        f, f_s = _synced(torch, lambda: forces(yt))
        f64 = forces(yt.double())
        return (float((f.double() - f64).abs().max() / f64.abs().max()),
                bool(torch.equal(f, forces(yt))), f_s)

    y0 = dg._start(n, 2, 0, dev)  # the public run's seeded start
    err0, same0, f_s = force_check(y0)
    y250 = kept.pop("state")[0]
    err1, same1, _ = force_check(y250)
    bar("forces_f64", max(err0, err1) <= FA2_FORCE_FAIL and same0 and same1,
        rel_err_start=err0, rel_err_at_250=err1, fail_above=FA2_FORCE_FAIL,
        bit_identical=same0 and same1, radius_at_250=float(y250.abs().max()))
    del y250, kept

    # the mesh: a short run from the same start, then a longer one
    mesh = card_mesh(torch)
    init = y0.cpu().numpy()
    y5 = draw_graph(S, n_iter=FA2_MESH_SHORT, init=init)
    y5m = draw_graph(S, n_iter=FA2_MESH_SHORT, init=init, mesh=mesh)
    close = bool(np.allclose(y5m, y5, rtol=5e-3, atol=1e-2))
    ym, steps["draw_graph_mesh"] = _synced(torch, lambda: draw_graph(S, n_iter=FA2_MESH_ITER,
                                                                      mesh=mesh))
    sep_m = fa2_separation(ym, labels)
    bar("mesh", close and np.isfinite(ym).all() and sep_m > FA2_SEP_FAIL,
        short_max_abs_diff=float(np.abs(y5m - y5).max()), short_rtol=5e-3, short_atol=1e-2,
        separation=sep_m, fail_below=FA2_SEP_FAIL)
    emit("draw_graph", n=n, edges=int(S.nnz), iterations=500, block=block,
         ms_per_iteration=steps["draw_graph"] / 500 * 1e3, force_eval_ms=f_s * 1e3,
         mesh_entries=mesh.size, mesh_iterations=FA2_MESH_ITER,
         mesh_ms_per_iteration=steps["draw_graph_mesh"] / FA2_MESH_ITER * 1e3,
         steps_s=steps, checks=checks, peak_alloc_gb=torch.cuda.max_memory_allocated() / 1e9,
         card=card())
    if failed:
        raise AssertionError(f"draw_graph: bars not met: {failed}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from single_algebra_tpu_torch.types import precision_policy  # fails outside the repo

    # the entry points enter the policy themselves; the phases that call
    # the port's internals directly (Gram tiers, breakdowns, products) run
    # under it too
    # the three cells' count matrices, drawn in a worker while the card works
    data = CountsWorker([(N_CELLS, N_GENES), (DENSE_CELLS, DENSE_GENES),
                         (TILED_CELLS, TILED_GENES)])
    try:
        with precision_policy():
            return _phases(torch, data)
    finally:
        data.close()


def timed(name: str, fn, *args):
    """``fn(*args)``, then a ``seconds`` line: the smoke's time budget by
    phase group."""

    t0 = time.perf_counter()
    out = fn(*args)
    emit("seconds", of=name, s=time.perf_counter() - t0)
    return out


def _phases(torch, data) -> int:
    t0 = time.perf_counter()
    phase_env(torch)
    timed("build", phase_build)
    kern = timed("kernel", phase_kernel, torch)
    tiled_kern = {}
    layout_launches = timed("jax_layout", phase_jax_layout, torch, kern, tiled_kern)
    timed("gram_tiers", phase_gram_tiers, torch)
    held = kern.pop("slab_widths")
    launches, kern["library_ms"], X, ev_true, single = timed("main_path", phase_main_path,
                                                            torch, held, data)
    torch.cuda.empty_cache()
    launches += timed("mesh_cell1", phase_mesh_cell1, torch, X, single, ev_true, held)
    del single
    torch.cuda.empty_cache()
    m = timed("stats", phase_stats, torch, X)
    ctx = timed("pipeline", phase_pipeline, torch, m)
    sc_launches, sc = timed("scrna", phase_scrna, torch, m, ctx, held)
    launches += sc_launches
    timed("harmony", phase_harmony, torch, sc)
    de_single = timed("de", phase_de, torch, sc)
    timed("mesh_pipeline", phase_mesh_pipeline, torch, m, sc, de_single)
    del de_single
    timed("metrics_scrna", phase_metrics_scrna, torch, sc)
    timed("analysis_scrna", phase_analysis_scrna, torch, sc, X)
    timed("io", phase_io, torch, X)
    del m, sc
    torch.cuda.empty_cache()
    stream_launches, single = timed("streaming", phase_streaming, torch, X, ev_true, held,
                                    ctx["Xl64"])
    launches += stream_launches
    launches += timed("mesh_streaming", phase_mesh_streaming, torch, X, single, held)
    del X, single
    torch.cuda.empty_cache()
    timed("sparse_engine", phase_sparse_engine, torch, ctx)
    timed("similarity", phase_similarity, torch, ctx.pop("T"))
    del ctx
    torch.cuda.empty_cache()
    launches += timed("dense_path", phase_dense_path, torch, data)
    torch.cuda.empty_cache()
    timed("kernel_tiled", phase_kernel_tiled, torch, tiled_kern)
    tiled_launches, mesh_launches = timed("tiled_path", phase_tiled_path, torch, tiled_kern, data)
    tiled_launches = {name: tiled_launches[name] + mesh_launches[name] + layout_launches[name]
                      for name in tiled_launches}
    torch.cuda.empty_cache()
    timed("tsne", phase_tsne, torch)
    blobs = timed("scrna_blobs", phase_scrna_blobs, torch)
    timed("draw_graph", phase_draw_graph, torch, blobs)
    timed("metrics_blobs", phase_metrics_blobs, torch, blobs)
    timed("analysis_blobs", phase_analysis_blobs, torch, blobs)
    del blobs
    emit("seconds", of="smoke", s=time.perf_counter() - t0)
    launches += layout_launches["tiled_ell_densify_t"]
    kernels = [dict(name="tiled_ell_densify_t", source=KERNEL_SRC, line=221,
                    launches=launches, **kern)]
    for name, line in (("tiled_ell_spmm_t", 135), ("tiled_ell_rmv_t", 299)):
        kernels.append(dict(name=name, source=TILED_SRC, line=line,
                            launches=tiled_launches[name], **tiled_kern[name]))
    print(json.dumps({"kernels": [{
        "name": k["name"], "route": "cuda", "source": k["source"],
        "replaces": f"{TPU_KERNELS}:{k['line']}", "launches": k["launches"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": k["library_ms"],
    } for k in kernels]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
