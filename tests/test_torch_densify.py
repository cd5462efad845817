"""Densify kernel of the torch port against the JAX Pallas kernel.

``tiled_ell_densify_t`` must reproduce the Pallas kernel bit for bit
(``array_equal``) for int8, bf16 and f32 outputs, including padding slots,
duplicate ids (which sum in slot order) and ids outside the tile. On the
CPU the wrapper runs the plain PyTorch version; the ``requires_cuda``
tests hold the Hopper kernel to that plain version and skip without a
card. JAX is imported inside the parity tests only, so the CUDA tests of
this file also run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_densify.py -m requires_cuda
"""

import numpy as np
import pytest
import torch

from single_algebra_tpu_torch.ops import densify
from single_algebra_tpu_torch.ops.densify import (
    tiled_ell_densify_t,
    tiled_ell_densify_t_plain,
)

OUT_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}


def payload(seed, ntiles, wt, R, ct, *, dup=False, bad_ids=False, frac=False):
    """Random transposed tiled payload ``[ntiles*wt, R]`` (numpy f32/int32)
    with half the slots padding ``(0, 0)``."""

    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 60, (ntiles * wt, R)).astype(np.float32)
    if frac:
        vals += rng.random(vals.shape).astype(np.float32)
    ids = rng.integers(0, 4 if dup else ct, (ntiles * wt, R)).astype(np.int32)
    if bad_ids:
        ids[rng.random(ids.shape) < 0.1] = ct + 3
        ids[rng.random(ids.shape) < 0.05] = -1
    pad = rng.random(vals.shape) < 0.5
    vals[pad] = 0.0
    ids[pad] = 0
    return vals, ids


def jax_densify(vals, ids, *, wt, ntiles, ct, out_dtype):
    """The Pallas kernel in interpret mode, as the JAX package's tests run it."""

    import jax.numpy as jnp

    from single_algebra_tpu.ops.pallas.spmm_kernel import tiled_ell_densify_t as jk

    jdt = {"int8": jnp.int8, "bfloat16": jnp.bfloat16, "float32": jnp.float32}[out_dtype]
    out = jk(jnp.asarray(vals), jnp.asarray(ids), wt=wt, ntiles=ntiles,
             col_tile=ct, block_rows=128, out_dtype=jdt, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("out_dtype", list(OUT_DTYPES))
@pytest.mark.parametrize("case", ["plain", "dup_ids", "bad_ids"])
def test_densify_matches_pallas(out_dtype, case):
    ntiles, wt, ct, slab = 3, 8, 128, 256
    vals, ids = payload(
        1, ntiles, wt, 2 * slab, ct, dup=case == "dup_ids",
        bad_ids=case == "bad_ids", frac=out_dtype != "int8",
    )
    want = jax_densify(vals[:, slab:], ids[:, slab:], wt=wt, ntiles=ntiles,
                       ct=ct, out_dtype=out_dtype)
    # the port reads the second slab through its offset (no slab copy)
    got = tiled_ell_densify_t(
        torch.from_numpy(vals), torch.from_numpy(ids), wt=wt, ntiles=ntiles,
        col_tile=ct, out_dtype=OUT_DTYPES[out_dtype], row_offset=slab, rows=slab,
    )
    assert got.dtype == OUT_DTYPES[out_dtype]
    assert tuple(got.shape) == (ntiles * ct, slab)
    np.testing.assert_array_equal(got.float().numpy(), want)


# (case, wt, col_tile, slab offset, slab rows, duplicate ids, ids outside the tile)
SLAB_CASES = [
    ("wt4", 4, 128, 0, 256, False, False),
    ("wt8_offset", 8, 128, 128, 384, False, False),
    ("wt16_dup", 16, 128, 256, 256, True, False),
    ("wt8_bad_ids", 8, 128, 128, 128, False, True),
    ("wt4_dup_bad_ct64", 4, 64, 384, 128, True, True),
    ("wt16_ct256", 16, 256, 0, 128, False, True),
]


@pytest.mark.parametrize("out_dtype", list(OUT_DTYPES))
@pytest.mark.parametrize("case", SLAB_CASES, ids=[c[0] for c in SLAB_CASES])
def test_densify_slab_cases_match_pallas(out_dtype, case):
    """wt in {4, 8, 16}, duplicate and out-of-range ids, a slab at a
    non-zero offset, several column tiles: the CPU twins of the
    ``requires_cuda`` cases below, against the Pallas kernel."""

    _, wt, ct, off, rows, dup, bad = case
    ntiles = 2
    vals, ids = payload(7, ntiles, wt, 512, ct, dup=dup, bad_ids=bad,
                        frac=out_dtype != "int8")
    want = jax_densify(vals[:, off:off + rows], ids[:, off:off + rows], wt=wt,
                       ntiles=ntiles, ct=ct, out_dtype=out_dtype)
    got = tiled_ell_densify_t(
        torch.from_numpy(vals), torch.from_numpy(ids), wt=wt, ntiles=ntiles,
        col_tile=ct, out_dtype=OUT_DTYPES[out_dtype], row_offset=off, rows=rows,
    )
    assert tuple(got.shape) == (ntiles * ct, rows)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float64])
def test_plain_scatter_equals_the_onehot_select_add(out_dtype):
    """The plain version's per-slot scatter-add gives the bits of the TPU
    kernel's one-hot select-add, signed zeros, NaN, infinities, duplicate
    ids and ids outside the tile included."""

    ntiles, wt, ct, R = 3, 8, 16, 64
    vals, ids = payload(11, ntiles, wt, R, ct, dup=True, bad_ids=True, frac=True)
    rng = np.random.default_rng(12)
    special = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, -3.5], np.float32)
    pick = rng.random(vals.shape) < 0.1
    vals[pick] = rng.choice(special, int(pick.sum()))
    tv, ti = torch.from_numpy(vals), torch.from_numpy(ids)
    got = tiled_ell_densify_t_plain(tv, ti, wt=wt, ntiles=ntiles, col_tile=ct,
                                    out_dtype=out_dtype)
    td = tv.to(out_dtype).reshape(ntiles, wt, R)
    tl = ti.reshape(ntiles, wt, R)
    col = torch.arange(ct, dtype=torch.int32).view(1, -1, 1)
    want = torch.zeros((ntiles, ct, R), dtype=out_dtype)
    for w in range(wt):
        want += torch.where(col == tl[:, w:w + 1], td[:, w:w + 1],
                            torch.zeros((), dtype=out_dtype))
    bits = torch.int32 if out_dtype == torch.float32 else torch.int64
    assert torch.equal(got.view(bits), want.reshape(ntiles * ct, R).view(bits))
    assert bool(torch.isnan(got).any()) and bool(torch.isinf(got).any())


def test_int8_saturates_like_xla():
    # duplicate ids can sum past the int8 range: both saturate
    vals = np.array([[100.0, -100.0], [100.0, -100.0]], np.float32)
    ids = np.zeros((2, 2), np.int32)
    got = tiled_ell_densify_t(torch.from_numpy(vals), torch.from_numpy(ids),
                              wt=2, ntiles=1, col_tile=8, out_dtype=torch.int8)
    assert got[0].tolist() == [127, -128]


def test_cpu_route_counts_no_launch():
    vals, ids = payload(2, 2, 8, 64, 32)
    densify.reset_launch_counts()
    out = tiled_ell_densify_t(torch.from_numpy(vals), torch.from_numpy(ids),
                              wt=8, ntiles=2, col_tile=32)
    assert out.dtype == torch.bfloat16  # the JAX default out_dtype
    assert densify.launch_counts["tiled_ell_densify_t"] == 0


@pytest.mark.parametrize(
    "kw, err",
    [
        (dict(wt=4), ValueError),  # slot rows != ntiles * wt
        (dict(row_offset=40), ValueError),  # slab past the payload
        (dict(out_dtype=torch.float16), TypeError),
        (dict(ids_dtype=torch.int64), TypeError),
    ],
)
def test_densify_rejects_bad_arguments(kw, err):
    vals, ids = payload(3, 2, 8, 64, 32)
    args = dict(wt=8, ntiles=2, col_tile=32, out_dtype=torch.float32,
                row_offset=0, rows=32)
    ids_dtype = kw.pop("ids_dtype", torch.int32)
    args.update(kw)
    with pytest.raises(err):
        tiled_ell_densify_t(torch.from_numpy(vals),
                            torch.from_numpy(ids).to(ids_dtype), **args)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("out_dtype", list(OUT_DTYPES))
@pytest.mark.parametrize("case", ["plain", "dup_ids", "bad_ids"])
def test_cuda_kernel_matches_plain(cuda, out_dtype, case):
    ntiles, wt, ct, slab = 5, 16, 256, 1024
    vals, ids = payload(4, ntiles, wt, 3 * slab, ct, dup=case == "dup_ids",
                        bad_ids=case == "bad_ids", frac=out_dtype != "int8")
    tv, ti = torch.from_numpy(vals).to(cuda), torch.from_numpy(ids).to(cuda)
    kw = dict(wt=wt, ntiles=ntiles, col_tile=ct, out_dtype=OUT_DTYPES[out_dtype],
              row_offset=slab, rows=slab)
    densify.reset_launch_counts()
    got = tiled_ell_densify_t(tv, ti, **kw)
    torch.cuda.synchronize()
    assert densify.launch_counts["tiled_ell_densify_t"] == 1
    want = tiled_ell_densify_t_plain(tv, ti, **kw)
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("ct", [512, 1024])
def test_cuda_kernel_wide_tiles(cuda, ct):
    # col_tile 512/1024 need more than 48 KB of shared memory per block
    vals, ids = payload(5, 2, 8, 256, ct)
    tv, ti = torch.from_numpy(vals).to(cuda), torch.from_numpy(ids).to(cuda)
    kw = dict(wt=8, ntiles=2, col_tile=ct, out_dtype=torch.float32)
    assert torch.equal(tiled_ell_densify_t(tv, ti, **kw),
                       tiled_ell_densify_t_plain(tv, ti, **kw))


@pytest.mark.requires_cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda):
    vals, ids = payload(6, 2, 8, 64, 32)
    tv, ti = torch.from_numpy(vals).to(cuda), torch.from_numpy(ids).to(cuda)
    kw = dict(wt=8, ntiles=2, col_tile=32)
    with pytest.raises(TypeError):  # float64 payloads are refused
        tiled_ell_densify_t(tv.double(), ti, **kw)
    with pytest.raises(ValueError):  # slab rows not a multiple of 32
        tiled_ell_densify_t(tv, ti, rows=48, **kw)
    with pytest.raises(ValueError):  # values on the card, ids on the host
        tiled_ell_densify_t(tv, ti.cpu(), **kw)


# (case, wt, col_tile, payload rows, slab offset, slab rows, dup ids, bad ids)
CUDA_SLAB_CASES = [
    ("wt4", 4, 256, 2048, 0, 1024, False, False),
    ("wt8_offset", 8, 256, 3072, 1024, 1024, False, False),
    ("wt8_ragged", 8, 256, 2048, 96, 1184, False, False),  # rows % 256 != 0
    ("wt16_dup", 16, 256, 2048, 512, 1024, True, False),
    ("wt8_bad_ids", 8, 256, 1024, 0, 1024, False, True),
    ("wt5_ct200", 5, 200, 1024, 32, 448, True, True),
    ("wt12_ct40", 12, 40, 512, 0, 512, False, True),
    ("wt16_ct1024", 16, 1024, 512, 0, 512, True, False),
    # past 16 slots: the kernel's tail takes the row 16 slots at a time
    ("wt24_tail", 24, 256, 1024, 256, 512, True, True),
    ("wt32_tail", 32, 256, 1024, 0, 1024, False, False),
    ("wt32_tail_dup_ragged", 32, 256, 1024, 96, 800, True, True),
    ("wt40_tail_ct200", 40, 200, 512, 32, 448, True, True),
    ("wt64_tail_dup", 64, 256, 512, 0, 512, True, False),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("out_dtype", list(OUT_DTYPES))
@pytest.mark.parametrize("case", CUDA_SLAB_CASES, ids=[c[0] for c in CUDA_SLAB_CASES])
def test_cuda_kernels_bit_identical(cuda, out_dtype, case):
    """The kernel and the plain version give the same bits (compared as
    raw bytes, so -0 != +0); the kernel's launch is counted once."""

    _, wt, ct, R, off, rows, dup, bad = case
    ntiles = 3
    vals, ids = payload(8, ntiles, wt, R, ct, dup=dup, bad_ids=bad,
                        frac=out_dtype != "int8")
    vals[0, off] = -0.0  # a stored negative zero sums to +0, as in the one-hot form
    tv, ti = torch.from_numpy(vals).to(cuda), torch.from_numpy(ids).to(cuda)
    kw = dict(wt=wt, ntiles=ntiles, col_tile=ct, out_dtype=OUT_DTYPES[out_dtype],
              row_offset=off, rows=rows)
    densify.reset_launch_counts()
    got = tiled_ell_densify_t(tv, ti, **kw)
    torch.cuda.synchronize()
    assert densify.launch_counts["tiled_ell_densify_t"] == 1
    want = tiled_ell_densify_t_plain(tv, ti, **kw)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
