"""The one general generator: a closed loop with one client.

An analyst waits on each fit before asking for the next, so requests are
issued back to back. What one request does is read from the traffic
mix's file (``traffic/<mix>.json``) and the configuration's file
(``configs/<config>.json``):

* ``intake``: ``"per_request"`` makes ``SparseMatrix.from_scipy`` of the
  host CSR in every request (a fresh matrix, no operator cache survives),
  ``"setup"`` makes it and its engine once in set-up (a refit).
* ``fit``: the configuration's PCA settings; ``reseed`` draws a new
  ``random_seed`` for every request from the run's seed.
* ``warmup``: ``{"rows": r}`` runs the request once on ``r`` rows taken
  at an even stride from the cell's own matrix, ``{"requests": r}`` runs
  ``r`` requests on the held matrix.

Every request ends in ``torch.cuda.synchronize()`` (on a card) with its
scores on the device. The port is imported here, never at module import.
"""

from __future__ import annotations

import time

import numpy as np

from . import datagen
from .tracewin import Spans

__all__ = ["Workload"]

_RESEED = 1  # the fits' random_seed stream under the run's seed


class Workload:
    """One cell's data, set-up and request, on ``device``."""

    def __init__(self, config: dict, mix: dict, *, seed: int, device: str):
        import torch

        import single_algebra_tpu_torch as sat

        self.torch, self.sat = torch, sat
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.engine = config["pca"].get("engine", "auto")
        self.X = None
        self.held = None  # (matrix, engine) built in set-up
        self.products: list | None = None  # (kind, operand width) per product, when probed
        self.spans = Spans()  # the host spans of every request
        self._seeds = np.random.default_rng(datagen.seed_sequence(seed, _RESEED))

    # -- set-up ------------------------------------------------------------

    def draw(self) -> None:
        c = self.config
        self.X = datagen.cluster_counts(int(c["rows"]), int(c["cols"]), seed=self.seed,
                                        n_clusters=int(c["clusters"]), density=float(c["density"]))

    def build_kernels(self) -> None:
        from single_algebra_tpu_torch.native import build as native
        from single_algebra_tpu_torch.ops import cuda_lib

        native.get_lib()
        if self.device.type == "cuda":
            cuda_lib.build_all()

    def hold(self) -> None:
        """The matrix and its engine, built once (``intake: setup``)."""

        if self.mix["intake"] != "setup":
            return
        from single_algebra_tpu_torch.models.pca import make_engine_operator

        m = self.sat.SparseMatrix.from_scipy(self.X, device=self.device)
        eng = make_engine_operator(m, self.engine)
        self.sync()
        self.held = (m, eng)

    def warm_up(self) -> None:
        w = self.mix.get("warmup", {})
        if "rows" in w:
            n = self.X.shape[0]
            stride = max(n // int(w["rows"]), 1)
            self.request(self.X[::stride])
        for _ in range(int(w.get("requests", 0))):
            self.request(None)

    def probe_products(self) -> None:
        """Record the operand width of every product of the held engine
        (a traced run's kernel metrics count their work from it)."""

        if self.held is None:
            return
        self.products = []
        eng = self.held[1]
        for attr, kind in (("_mv", "mv"), ("_rmv", "rmv")):
            orig = getattr(eng, attr, None)
            if orig is None:
                continue

            def wrapped(operand, *args, _orig=orig, _kind=kind, **kw):
                self.products.append((_kind, int(operand.shape[1])))
                return _orig(operand, *args, **kw)

            setattr(eng, attr, wrapped)

    # -- one request -------------------------------------------------------

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _builder(self, seed):
        from single_algebra_tpu_torch.types import PowerIterationNormalizer, SVDMethod

        pca = self.config["pca"]
        if pca["svd_method"] != "randomized":
            raise ValueError(f"unknown svd_method {pca['svd_method']!r}")
        b = self.sat.SparsePCABuilder().n_components(int(pca["n_components"])).engine(self.engine)
        b = b.svd_method(SVDMethod.random(
            int(pca["n_oversamples"]), int(pca["n_power_iterations"]),
            getattr(PowerIterationNormalizer, pca["normalizer"])))
        if seed is not None:
            b = b.random_seed(seed)
        return b

    def request(self, X):
        """One request on the host CSR ``X`` (``None``: the held matrix) ->
        (outputs, record). ``record`` holds the benchmark's spans and the
        program's own counters."""

        from single_algebra_tpu_torch.ops import cuda_lib

        rf = self.spans.span
        rec = {"spans": {}, "counters": {}}
        cuda_lib.reset_launch_counts()
        if X is None:
            m = self.held[0]
        else:
            t0 = time.perf_counter()
            with rf("portbench.from_scipy"):
                m = self.sat.SparseMatrix.from_scipy(X, device=self.device)
            rec["spans"]["from_scipy"] = time.perf_counter() - t0
        seed = int(self._seeds.integers(0, 2**31 - 1)) if self.mix["fit"].get("reseed") else None
        with rf("portbench.fit_transform"):
            pca = self._builder(seed).build()
            T = pca.fit_transform(m)
            self.sync()
        ev = np.asarray(pca.explained_variance_, np.float64)
        rec["counters"]["fit_timings"] = dict(getattr(pca, "_fit_timings", {}))
        if X is not None:
            self._engine_counters(m, rec["counters"])
        out = {"ev": ev, "vt": pca.components_, "t": T,
               "seed": seed if seed is not None else pca.random_seed}
        return out, rec

    def _engine_counters(self, m, counters: dict) -> None:
        """The engine a fresh request built: its build seconds, and the
        densify passes per output type (launches over slabs a pass)."""

        from single_algebra_tpu_torch.ops import cuda_lib

        eng = m._operator_cache.get(self.engine)
        if eng is None:
            return
        counters["engine"] = type(eng).__name__
        counters["build_seconds"] = dict(getattr(eng, "build_seconds", {}))
        launches = dict(cuda_lib.densify_launches_by_dtype)
        if launches and hasattr(eng, "n_padded"):
            from single_algebra_tpu_torch.linalg.gram import _slab_for

            slabs = eng.n_padded // _slab_for(m.shape[0])
            counters["densify_passes"] = {d: c / slabs for d, c in launches.items()}
