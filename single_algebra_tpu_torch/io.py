"""h5ad (AnnData-on-HDF5) and 10x mtx IO.

Counterpart of ``single_algebra_tpu/io.py``: reads and writes the h5ad
encoding over ``h5py`` (no ``anndata`` needed) for what expression
matrices need: ``X`` (or ``layers/<name>``) as csr / csc groups or dense
datasets, the ``obs`` / ``var`` dataframes (columns, categoricals, the
``_index``) and ``obsm`` matrices; :func:`iter_h5ad_chunks` streams CSR
row slabs off the on-disk ``indptr`` without loading ``X``;
:func:`read_10x_mtx` reads a CellRanger mtx directory. The files follow
the anndata on-disk spec, so they open in scanpy and back.

``h5py`` is imported inside the h5ad functions: the package and the mtx
reader work without it. A matrix read here is built on ``device`` (the
card unless the caller names another).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = [
    "AnnLite",
    "read_h5ad",
    "write_h5ad",
    "iter_h5ad_chunks",
    "read_10x_mtx",
]


@dataclasses.dataclass
class AnnLite:
    """Minimal AnnData: the expression matrix + aligned metadata."""

    X: object  # SparseMatrix (or None when skip_x)
    obs: Dict[str, np.ndarray]
    var: Dict[str, np.ndarray]
    obs_names: np.ndarray
    var_names: np.ndarray
    obsm: Dict[str, np.ndarray]
    shape: tuple

    def __repr__(self):
        return (
            f"AnnLite(n_obs={self.shape[0]}, n_vars={self.shape[1]}, "
            f"obs={list(self.obs)}, var={list(self.var)}, "
            f"obsm={list(self.obsm)})"
        )


def _decode_strings(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind in ("S", "O"):
        return np.asarray(
            [v.decode() if isinstance(v, bytes) else str(v) for v in a]
        )
    return a


def _read_column(node) -> np.ndarray:
    import h5py

    if isinstance(node, h5py.Group):
        enc = node.attrs.get("encoding-type", "")
        if enc == "categorical" or (
            "categories" in node and "codes" in node
        ):
            cats = _decode_strings(node["categories"][...])
            codes = node["codes"][...]
            out = np.empty(codes.shape, object)
            valid = codes >= 0
            out[valid] = cats[codes[valid]]
            out[~valid] = None
            return out
        raise ValueError(
            f"Unsupported h5ad column group encoding {enc!r} at {node.name}"
        )
    return _decode_strings(node[...])


def _read_dataframe(g) -> tuple[Dict[str, np.ndarray], np.ndarray]:
    index_key = g.attrs.get("_index", "_index")
    if isinstance(index_key, bytes):
        index_key = index_key.decode()
    cols = {}
    names = None
    for key in g.keys():
        if key == "__categories":  # legacy anndata side table
            continue
        val = _read_column(g[key])
        if key == index_key:
            names = val
        else:
            cols[key] = val
    if names is None:
        n = len(next(iter(cols.values()))) if cols else 0
        names = np.asarray([str(i) for i in range(n)])
    return cols, names


def _x_meta(node) -> tuple[str, tuple]:
    """(kind, shape) for an X-like node: 'csr' | 'csc' | 'dense'."""

    import h5py

    if isinstance(node, h5py.Group):
        enc = node.attrs.get("encoding-type", "")
        if isinstance(enc, bytes):
            enc = enc.decode()
        shape = tuple(int(v) for v in node.attrs["shape"])
        if enc.startswith("csr") or (
            not enc and "indptr" in node
            and node["indptr"].shape[0] == shape[0] + 1
        ):
            return "csr", shape
        if enc.startswith("csc"):
            return "csc", shape
        # fall back on indptr length
        if node["indptr"].shape[0] == shape[0] + 1:
            return "csr", shape
        return "csc", shape
    return "dense", tuple(node.shape)


def _read_x(node, dtype):
    import scipy.sparse as sp

    kind, shape = _x_meta(node)
    if kind == "dense":
        return sp.csr_matrix(np.asarray(node[...], dtype=dtype))
    cls = sp.csr_matrix if kind == "csr" else sp.csc_matrix
    mat = cls(
        (
            np.asarray(node["data"][...], dtype=dtype),
            node["indices"][...],
            node["indptr"][...],
        ),
        shape=shape,
    )
    return mat.tocsr()


def read_h5ad(
    path: str,
    *,
    layer: Optional[str] = None,
    dtype=np.float32,
    skip_x: bool = False,
    device="cuda",
):
    """Load an ``.h5ad`` file into an :class:`AnnLite`.

    ``X`` (or ``layers/<layer>``) becomes a :class:`SparseMatrix` on
    ``device``; obs/var dataframes and obsm matrices come along.
    ``skip_x=True`` reads only the metadata — pair with
    :func:`iter_h5ad_chunks` for out-of-core runs.
    """

    import h5py

    from .sparse.matrix import SparseMatrix

    with h5py.File(path, "r") as f:
        xnode = f[f"layers/{layer}"] if layer else f["X"]
        _, shape = _x_meta(xnode)
        obs, obs_names = (
            _read_dataframe(f["obs"]) if "obs" in f else ({}, None)
        )
        var, var_names = (
            _read_dataframe(f["var"]) if "var" in f else ({}, None)
        )
        if obs_names is None:
            obs_names = np.asarray([str(i) for i in range(shape[0])])
        if var_names is None:
            var_names = np.asarray([str(i) for i in range(shape[1])])
        obsm = {}
        if "obsm" in f:
            for key in f["obsm"].keys():
                obsm[key] = np.asarray(f["obsm"][key][...])
        X = None
        if not skip_x:
            X = SparseMatrix.from_scipy(
                _read_x(xnode, dtype), device=device
            )
    return AnnLite(
        X=X,
        obs=obs,
        var=var,
        obs_names=np.asarray(obs_names),
        var_names=np.asarray(var_names),
        obsm=obsm,
        shape=shape,
    )


def iter_h5ad_chunks(
    path: str,
    *,
    chunk_rows: int = 65536,
    layer: Optional[str] = None,
    dtype=np.float32,
) -> Iterator:
    """Yield ``X`` as scipy CSR row slabs WITHOUT loading the matrix.

    Reads ``data``/``indices`` ranges straight off the on-disk
    ``indptr`` (one contiguous HDF5 hyperslab per chunk) — memory stays
    O(chunk nnz) regardless of file size. Requires csr encoding (the
    anndata default) or a dense ``X`` (sliced row-wise).
    """

    import h5py
    import scipy.sparse as sp

    if chunk_rows < 1:
        raise ValueError(f"chunk_rows={chunk_rows} must be >= 1")
    with h5py.File(path, "r") as f:
        node = f[f"layers/{layer}"] if layer else f["X"]
        kind, shape = _x_meta(node)
        n, p = shape
        if kind == "dense":
            for r0 in range(0, n, chunk_rows):
                yield sp.csr_matrix(
                    np.asarray(node[r0:r0 + chunk_rows], dtype=dtype)
                )
            return
        if kind != "csr":
            raise ValueError(
                "iter_h5ad_chunks requires csr or dense X; got csc "
                "(convert once with anndata/scanpy or read_h5ad)"
            )
        indptr = node["indptr"][...]  # [n+1] — the only full-length read
        data, indices = node["data"], node["indices"]
        for r0 in range(0, n, chunk_rows):
            r1 = min(r0 + chunk_rows, n)
            s0, s1 = int(indptr[r0]), int(indptr[r1])
            yield sp.csr_matrix(
                (
                    np.asarray(data[s0:s1], dtype=dtype),
                    indices[s0:s1],
                    indptr[r0:r1 + 1] - s0,
                ),
                shape=(r1 - r0, p),
            )


def _open_maybe_gz(path: str, candidates, mode: str = "rt"):
    import gzip
    import os

    for name in candidates:
        for suffix, opener in (("", open), (".gz", gzip.open)):
            full = os.path.join(path, name + suffix)
            if os.path.exists(full):
                return opener(full, mode)
    raise FileNotFoundError(
        f"None of {candidates} (+.gz) found in {path!r}"
    )


def read_10x_mtx(path: str, *, dtype=np.float32, device="cuda"):
    """Load a 10x Genomics mtx directory (CellRanger output).

    Expects ``matrix.mtx[.gz]`` + ``barcodes.tsv[.gz]`` +
    ``features.tsv[.gz]`` (or the legacy ``genes.tsv``) in ``path``.
    10x stores genes x cells; the result is transposed to the cells x
    genes orientation every API in this library uses, as a
    :class:`SparseMatrix` on ``device``.
    """

    import scipy.io as sio

    with _open_maybe_gz(path, ["matrix.mtx"], mode="rb") as f:
        M = sio.mmread(f)
    with _open_maybe_gz(path, ["barcodes.tsv"]) as f:
        barcodes = np.asarray([ln.strip().split("\t")[0] for ln in f])
    with _open_maybe_gz(path, ["features.tsv", "genes.tsv"]) as f:
        rows = [ln.rstrip("\r\n").split("\t") for ln in f]
    gene_ids = np.asarray([r[0] for r in rows])
    gene_names = np.asarray([r[1] if len(r) > 1 else r[0] for r in rows])
    var = {"gene_ids": gene_ids}
    if any(len(r) > 2 for r in rows):
        var["feature_types"] = np.asarray(
            [r[2] if len(r) > 2 else "" for r in rows]
        )

    X = M.T.tocsr().astype(dtype)  # genes x cells -> cells x genes
    if X.shape != (len(barcodes), len(gene_names)):
        raise ValueError(
            f"matrix.mtx shape {M.shape} does not match "
            f"{len(barcodes)} barcodes x {len(gene_names)} features"
        )
    from .sparse.matrix import SparseMatrix

    return AnnLite(
        X=SparseMatrix.from_scipy(X, device=device),
        obs={},
        var=var,
        obs_names=barcodes,
        var_names=gene_names,
        obsm={},
        shape=X.shape,
    )


def _write_strings(g, key, values: np.ndarray):
    import h5py

    ds = g.create_dataset(
        key,
        data=np.asarray(
            [str(v) for v in values], dtype=h5py.string_dtype()
        ),
    )
    ds.attrs["encoding-type"] = "string-array"
    ds.attrs["encoding-version"] = "0.2.0"
    return ds


def _write_column(g, key, values: np.ndarray):
    values = np.asarray(values)
    if values.dtype.kind in ("U", "S", "O"):
        _write_strings(g, key, values)
    else:
        ds = g.create_dataset(key, data=values)
        ds.attrs["encoding-type"] = "array"
        ds.attrs["encoding-version"] = "0.2.0"


def _write_dataframe(f, name, cols: Dict[str, np.ndarray], index: np.ndarray):
    import h5py

    g = f.create_group(name)
    g.attrs["encoding-type"] = "dataframe"
    g.attrs["encoding-version"] = "0.2.0"
    g.attrs["_index"] = "_index"
    g.attrs["column-order"] = np.asarray(
        list(cols), dtype=h5py.string_dtype()
    )
    _write_strings(g, "_index", index)
    for key, val in cols.items():
        if len(np.asarray(val)) != len(index):
            raise ValueError(
                f"{name}[{key!r}] length {len(np.asarray(val))} != "
                f"index length {len(index)}"
            )
        _write_column(g, key, val)


def write_h5ad(
    path: str,
    X,
    *,
    obs: Optional[Dict[str, np.ndarray]] = None,
    var: Optional[Dict[str, np.ndarray]] = None,
    obs_names=None,
    var_names=None,
    obsm: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write an anndata-spec ``.h5ad``: csr X + obs/var/obsm.

    ``X`` may be a :class:`SparseMatrix`, any scipy sparse matrix, or a
    dense array (stored csr either way).
    """

    import h5py
    import scipy.sparse as sp

    from .sparse.matrix import SparseMatrix

    if isinstance(X, SparseMatrix):
        Xs = X.to_scipy().tocsr()
    elif sp.issparse(X):
        Xs = X.tocsr()
    else:
        Xs = sp.csr_matrix(np.asarray(X))
    n, p = Xs.shape
    obs_names = (
        np.asarray([f"cell_{i}" for i in range(n)])
        if obs_names is None
        else np.asarray(obs_names)
    )
    var_names = (
        np.asarray([f"gene_{i}" for i in range(p)])
        if var_names is None
        else np.asarray(var_names)
    )
    if len(obs_names) != n or len(var_names) != p:
        raise ValueError(
            f"obs_names/var_names lengths {len(obs_names)}/{len(var_names)} "
            f"do not match X shape {Xs.shape}"
        )
    with h5py.File(path, "w") as f:
        f.attrs["encoding-type"] = "anndata"
        f.attrs["encoding-version"] = "0.1.0"
        g = f.create_group("X")
        g.attrs["encoding-type"] = "csr_matrix"
        g.attrs["encoding-version"] = "0.1.0"
        g.attrs["shape"] = np.asarray([n, p], np.int64)
        g.create_dataset("data", data=Xs.data)
        g.create_dataset("indices", data=Xs.indices)
        g.create_dataset("indptr", data=Xs.indptr)
        _write_dataframe(f, "obs", obs or {}, obs_names)
        _write_dataframe(f, "var", var or {}, var_names)
        gm = f.create_group("obsm")
        gm.attrs["encoding-type"] = "dict"
        gm.attrs["encoding-version"] = "0.1.0"
        for key, val in (obsm or {}).items():
            val = np.asarray(val)
            if val.shape[0] != n:
                raise ValueError(
                    f"obsm[{key!r}] has {val.shape[0]} rows; X has {n}"
                )
            ds = gm.create_dataset(key, data=val)
            ds.attrs["encoding-type"] = "array"
            ds.attrs["encoding-version"] = "0.2.0"
