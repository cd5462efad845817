"""``io.py`` of the torch port against the JAX package.

Files written by either package read back identically in the other: the
same CSR (values exact), obs / var columns, names and obsm; the chunk
iterator's slabs are the full read's rows; a 10x mtx directory (gzipped
or plain, ``features.tsv`` or the legacy ``genes.tsv``) reads to the
JAX package's matrix and metadata. The matrices land on ``device``.
"""

import gzip
import importlib
import os

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch.io import (
    AnnLite,
    iter_h5ad_chunks,
    read_10x_mtx,
    read_h5ad,
    write_h5ad,
)
from tests.test_io import counts

jio = importlib.import_module("single_algebra_tpu.io")


def same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("as_matrix", [False, True])
def test_h5ad_round_trip_across_packages(tmp_path, writer, as_matrix):
    X = counts()
    path = str(tmp_path / "t.h5ad")
    emb = np.random.default_rng(1).standard_normal((300, 5)).astype(np.float32)
    kw = dict(obs={"total": np.asarray(X.sum(axis=1)).ravel(),
                   "kind": np.asarray(["a", "b", "c"] * 100)},
              var={"gene_id": np.asarray([f"ENSG{i:05d}" for i in range(120)])},
              obsm={"X_pca": emb})
    src = SparseMatrix.from_scipy(X, device="cpu") if (as_matrix and writer == "port") else X
    (write_h5ad if writer == "port" else jio.write_h5ad)(path, src, **kw)
    got = read_h5ad(path, device="cpu")
    want = jio.read_h5ad(path, device=False)
    assert isinstance(got, AnnLite) and got.shape == want.shape == (300, 120)
    assert got.X.device.type == "cpu"
    same_csr(got.X.to_scipy(), want.X.to_scipy())
    same_csr(got.X.to_scipy(), X)
    for a, b in ((got.obs, want.obs), (got.var, want.var), (got.obsm, want.obsm)):
        assert list(a) == list(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(got.obs_names, want.obs_names)
    np.testing.assert_array_equal(got.var_names, want.var_names)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("chunk_rows", [64, 1000])
def test_chunks_match_the_full_read_and_jax(tmp_path, chunk_rows):
    X = counts(seed=3)
    path = str(tmp_path / "c.h5ad")
    write_h5ad(path, X)
    got = list(iter_h5ad_chunks(path, chunk_rows=chunk_rows))
    want = list(jio.iter_h5ad_chunks(path, chunk_rows=chunk_rows))
    assert len(got) == len(want) == -(-300 // chunk_rows)
    for a, b in zip(got, want):
        same_csr(a, b)
    same_csr(sp.vstack(got), X)


def test_anndata_style_csc_categorical_and_skip_x(tmp_path):
    import h5py

    X = counts(n=60, p=40, seed=2).tocsc()
    path = str(tmp_path / "sc.h5ad")
    with h5py.File(path, "w") as f:
        g = f.create_group("X")
        g.attrs["encoding-type"] = "csc_matrix"
        g.attrs["shape"] = np.asarray([60, 40], np.int64)
        for key in ("data", "indices", "indptr"):
            g.create_dataset(key, data=getattr(X, key))
        obs = f.create_group("obs")
        obs.attrs["_index"] = "cell_id"
        obs.create_dataset("cell_id", data=np.asarray([f"c{i}" for i in range(60)], "S"))
        cat = obs.create_group("type")
        cat.attrs["encoding-type"] = "categorical"
        cat.create_dataset("categories", data=np.asarray(["T", "B"], "S"))
        cat.create_dataset("codes", data=np.asarray([0, 1, -1] * 20, np.int8))
        lay = f.create_group("layers").create_group("raw")
        lay.attrs["encoding-type"] = "csc_matrix"
        lay.attrs["shape"] = np.asarray([60, 40], np.int64)
        for key in ("data", "indices", "indptr"):
            lay.create_dataset(key, data=getattr(X, key) if key != "data" else X.data * 2)
    got, want = read_h5ad(path, device="cpu"), jio.read_h5ad(path, device=False)
    same_csr(got.X.to_scipy(), want.X.to_scipy())
    np.testing.assert_array_equal(got.obs["type"], want.obs["type"])
    assert got.obs_names[5] == "c5" and got.obs["type"][2] is None
    raw = read_h5ad(path, layer="raw", device="cpu")
    same_csr(raw.X.to_scipy(), jio.read_h5ad(path, layer="raw", device=False).X.to_scipy())
    meta = read_h5ad(path, skip_x=True, device="cpu")
    assert meta.X is None and meta.shape == (60, 40)
    with pytest.raises(ValueError, match="csr or dense"):
        next(iter_h5ad_chunks(path))


def test_dense_x_and_validation(tmp_path):
    import h5py

    D = counts(n=30, p=10, seed=4).toarray()
    path = str(tmp_path / "d.h5ad")
    with h5py.File(path, "w") as f:
        f.create_dataset("X", data=D)
    got = read_h5ad(path, device="cpu")
    np.testing.assert_array_equal(got.X.to_dense(), D)
    chunks = list(iter_h5ad_chunks(path, chunk_rows=7))
    np.testing.assert_array_equal(sp.vstack(chunks).toarray(), D)
    with pytest.raises(ValueError, match="chunk_rows"):
        next(iter_h5ad_chunks(path, chunk_rows=0))
    with pytest.raises(ValueError, match="do not match"):
        write_h5ad(str(tmp_path / "x.h5ad"), D, obs_names=["a"])
    with pytest.raises(ValueError, match="obsm"):
        write_h5ad(str(tmp_path / "y.h5ad"), D, obsm={"e": np.ones((3, 2))})


def tenx_dir(tmp_path, gz: bool, legacy: bool, n=50, p=20):
    X = counts(n=n, p=p, seed=5)
    d = tmp_path / f"tenx_{gz}_{legacy}"
    d.mkdir()
    opener = gzip.open if gz else open
    sfx = ".gz" if gz else ""
    with opener(str(d / f"matrix.mtx{sfx}"), "wb") as f:
        sio.mmwrite(f, X.T.tocoo())
    with opener(str(d / f"barcodes.tsv{sfx}"), "wt") as f:
        f.writelines(f"AAAC{i:04d}-1\n" for i in range(n))
    name = "genes.tsv" if legacy else "features.tsv"
    with opener(str(d / f"{name}{sfx}"), "wt") as f:
        for j in range(p):
            f.write(f"ENSG{j:05d}\tGENE{j}" + ("\n" if legacy else "\tGene Expression\n"))
    return str(d), X


@pytest.mark.parametrize("gz", [True, False])
@pytest.mark.parametrize("legacy", [True, False])
def test_read_10x_mtx_matches_jax(tmp_path, gz, legacy):
    d, X = tenx_dir(tmp_path, gz, legacy)
    got = read_10x_mtx(d, device="cpu")
    want = jio.read_10x_mtx(d, device=False)
    same_csr(got.X.to_scipy(), want.X.to_scipy())
    same_csr(got.X.to_scipy(), X)
    np.testing.assert_array_equal(got.obs_names, want.obs_names)
    np.testing.assert_array_equal(got.var_names, want.var_names)
    assert list(got.var) == list(want.var)
    for key in got.var:
        np.testing.assert_array_equal(got.var[key], want.var[key])
    with pytest.raises(FileNotFoundError):
        read_10x_mtx(str(tmp_path), device="cpu")
    os.remove(os.path.join(d, "barcodes.tsv" + (".gz" if gz else "")))
    with (gzip.open if gz else open)(os.path.join(d, "barcodes.tsv" + (".gz" if gz else "")),
                                     "wt") as f:
        f.write("only_one\n")
    with pytest.raises(ValueError, match="does not match"):
        read_10x_mtx(d, device="cpu")
