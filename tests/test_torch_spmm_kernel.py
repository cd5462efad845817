"""The tiled engine's kernels of the torch port against the JAX Pallas kernels.

``tiled_ell_spmm_t`` and ``tiled_ell_rmv_t`` on the CPU run their plain
versions, held here to the Pallas kernels in interpret mode on the same
numpy arrays (bf16 and f32 payloads and operands, kp 8 and 64, duplicate
ids, out-of-range ids, an all-padding row block) to 1e-6 of the largest
output, and float64 payloads to 1e-12. The ``requires_cuda`` tests hold
the Hopper kernels to the plain versions on the card (1e-5, the smoke's
bar: the kernels add slot by slot in float32, the plain versions contract
densified tiles) and skip without a card. JAX is imported inside the
parity tests only, so the CUDA tests of this file also run where JAX is
not installed:

    python -m pytest --noconftest tests/test_torch_spmm_kernel.py -m requires_cuda
"""

import numpy as np
import pytest
import torch

from single_algebra_tpu_torch.ops import cuda_lib
from single_algebra_tpu_torch.ops import spmm as tspmm
from single_algebra_tpu_torch.ops.spmm_kernel import (
    tiled_ell_rmv_form,
    tiled_ell_rmv_form_plain,
    tiled_ell_rmv_t,
    tiled_ell_rmv_t_plain,
    tiled_ell_spmm_t,
    tiled_ell_spmm_t_plain,
)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}


def payload(seed, ntiles, wt, R, ct, *, dtype="f32", frac=True):
    """Random transposed tiled payload ``[ntiles*wt, R]`` as torch CPU
    tensors: padding trails each group, a few groups hold duplicate ids, a
    few ids lie outside the tile, and the first 128 rows are all padding."""

    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 9, (ntiles * wt, R)).astype(np.float64)
    if frac:
        vals += rng.random(vals.shape)
    ids = rng.integers(0, ct, (ntiles * wt, R)).astype(np.int32)
    sizes = rng.integers(0, wt + 1, (ntiles, R))
    slot = np.arange(wt)[None, :, None]
    pad = (slot >= sizes[:, None, :]).reshape(ntiles * wt, R)
    dup = rng.random(ids.shape) < 0.1
    ids[dup] = ids[np.maximum(np.arange(ntiles * wt) - 1, 0)][dup]
    ids[rng.random(ids.shape) < 0.02] = ct + 5
    vals[pad] = 0.0
    ids[pad] = 0
    vals[:, :128] = 0.0
    ids[:, :128] = 0
    tv = torch.from_numpy(vals).to(DTYPES[dtype])
    return tv, torch.from_numpy(ids)


def operand(seed, kp, width, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((kp, width))).to(DTYPES[dtype])


def as_np(t):
    """Exact numpy form for JAX: bf16 goes through float32."""

    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def jax_kernel(name, vals, ids, op, *, wt, ntiles, ct):
    """The Pallas kernel in interpret mode, as the JAX package's tests run it."""

    import jax.numpy as jnp

    from single_algebra_tpu.ops.pallas import spmm_kernel as jk

    def arr(t):
        a = jnp.asarray(as_np(t))
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

    out = getattr(jk, name)(arr(vals), jnp.asarray(ids.numpy()), arr(op), wt=wt,
                            ntiles=ntiles, col_tile=ct, block_rows=128, interpret=True)
    return np.asarray(out)


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


CASES = [  # (payload, operand, kp)
    ("bf16", "bf16", 64),
    ("bf16", "f32", 64),
    ("f32", "f32", 8),
    ("bf16", "bf16", 8),
]


@pytest.mark.parametrize("pdt, odt, kp", CASES)
def test_spmm_plain_matches_pallas(pdt, odt, kp):
    ntiles, wt, ct, R = 3, 16, 128, 1024
    vals, ids = payload(1, ntiles, wt, R, ct, dtype=pdt, frac=pdt != "bf16")
    Bt = operand(2, kp, ntiles * ct, odt)
    got = tiled_ell_spmm_t(vals, ids, Bt, wt=wt, ntiles=ntiles, col_tile=ct, block_rows=128)
    assert got.dtype == torch.float32 and tuple(got.shape) == (kp, R)
    want = jax_kernel("tiled_ell_spmm_t", vals, ids, Bt, wt=wt, ntiles=ntiles, ct=ct)
    assert rel_err(got.numpy(), want) <= 1e-6
    assert not got[:, :128].any()  # the all-padding row block


@pytest.mark.parametrize("pdt, odt, kp", CASES)
def test_rmv_plain_matches_pallas(pdt, odt, kp):
    ntiles, wt, ct, R = 3, 16, 128, 1024
    vals, ids = payload(3, ntiles, wt, R, ct, dtype=pdt, frac=pdt != "bf16")
    Ct = operand(4, kp, R, odt)
    got = tiled_ell_rmv_t(vals, ids, Ct, wt=wt, ntiles=ntiles, col_tile=ct, block_rows=128)
    assert got.dtype == torch.float32 and tuple(got.shape) == (ntiles * ct, kp)
    want = jax_kernel("tiled_ell_rmv_t", vals, ids, Ct, wt=wt, ntiles=ntiles, ct=ct)
    assert rel_err(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("name", ["tiled_ell_spmm_t", "tiled_ell_rmv_t"])
def test_float64_plain_matches_pallas(name):
    ntiles, wt, ct, R = 2, 8, 128, 512
    vals, ids = payload(5, ntiles, wt, R, ct, dtype="f64")
    width = ntiles * ct if name == "tiled_ell_spmm_t" else R
    op = operand(6, 16, width, "f64")
    fn = tiled_ell_spmm_t if name == "tiled_ell_spmm_t" else tiled_ell_rmv_t
    got = fn(vals, ids, op, wt=wt, ntiles=ntiles, col_tile=ct, block_rows=128)
    assert got.dtype == torch.float64
    want = jax_kernel(name, vals, ids, op, wt=wt, ntiles=ntiles, ct=ct)
    assert rel_err(got.numpy(), want) <= 1e-12


def test_plain_groups_split_the_tiles(monkeypatch):
    # the plain versions densify groups of tiles; a tiny group budget gives
    # one tile per group and the same result
    from single_algebra_tpu_torch.ops import spmm_kernel as sk

    vals, ids = payload(7, 4, 8, 256, 64)
    Bt, Ct = operand(8, 8, 4 * 64, "f32"), operand(9, 8, 256, "f32")
    kw = dict(wt=8, ntiles=4, col_tile=64, block_rows=128)
    whole = (tiled_ell_spmm_t_plain(vals, ids, Bt, **kw), tiled_ell_rmv_t_plain(vals, ids, Ct, **kw))
    monkeypatch.setattr(sk, "_PLAIN_GROUP_BYTES", 1)
    assert len(sk._plain_groups(4, 64, 256)) == 4
    split = (tiled_ell_spmm_t_plain(vals, ids, Bt, **kw), tiled_ell_rmv_t_plain(vals, ids, Ct, **kw))
    for a, b in zip(whole, split):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-5)


def test_cpu_route_counts_no_launch():
    vals, ids = payload(10, 2, 8, 256, 64)
    cuda_lib.reset_launch_counts()
    tiled_ell_spmm_t(vals, ids, operand(11, 8, 128, "f32"), wt=8, ntiles=2, col_tile=64,
                     block_rows=128)
    tiled_ell_rmv_t(vals, ids, operand(12, 8, 256, "f32"), wt=8, ntiles=2, col_tile=64,
                    block_rows=128)
    tiled_ell_rmv_form(vals, ids, wt=8, ntiles=2, col_tile=64)
    assert cuda_lib.launch_counts == {
        "tiled_ell_densify_t": 0, "tiled_ell_spmm_t": 0, "tiled_ell_rmv_t": 0,
        "tiled_ell_rmv_form": 0,
    }


@pytest.mark.parametrize(
    "fn, kw, err",
    [
        ("spmm", dict(wt=4), ValueError),  # slot rows != ntiles * wt
        ("spmm", dict(block_rows=100), ValueError),  # R not a multiple of block_rows
        ("spmm", dict(kp=12), ValueError),  # kp not a multiple of 8
        ("rmv", dict(width=200), ValueError),  # Ct not [kp, R]
        ("rmv", dict(ids_dtype=torch.int64), TypeError),
    ],
)
def test_kernels_reject_bad_arguments(fn, kw, err):
    vals, ids = payload(13, 2, 8, 256, 64)
    ids = ids.to(kw.pop("ids_dtype", torch.int32))
    kp = kw.pop("kp", 8)
    width = kw.pop("width", 128 if fn == "spmm" else 256)
    args = dict(wt=8, ntiles=2, col_tile=64, block_rows=128)
    args.update(kw)
    f = tiled_ell_spmm_t if fn == "spmm" else tiled_ell_rmv_t
    with pytest.raises(err):
        f(vals, ids, operand(14, kp, width, "f32"), **args)


@pytest.mark.parametrize("ct", [128, 256, 512, 1024])
@pytest.mark.parametrize("pdt", ["bf16", "f32"])
@pytest.mark.parametrize("odt", ["bf16", "f32"])
def test_launch_plans_fit_shared_memory(ct, pdt, odt):
    """Every kp the kernels take gets a plan within the card's 232,448
    bytes of shared memory, for wt 8..64."""

    from single_algebra_tpu_torch.ops import spmm_kernel as sk

    p, o = DTYPES[pdt], DTYPES[odt]
    for kp in range(8, 257, 8):
        for wt in (8, 16, 24, 64):
            plan = sk._spmm_plan(wt, ct, kp, p, o)
            assert plan.smem <= 232_448 and plan.rows % 32 == 0 and plan.stages >= 2
            assert plan.kc * -(-kp // plan.kc) >= kp and plan.slots <= wt
        rplan = sk._rmv_plan(500_736, kp, 237, ct, o)
        assert rplan.smem <= 232_448 and rplan.rows % 256 == 0
        assert rplan.chunks * rplan.kc >= kp and rplan.col_groups * 256 >= ct
        assert rplan.nranges * rplan.rows >= 500_736 > (rplan.nranges - 1) * rplan.rows


@pytest.mark.parametrize("kp, ct", [(12, 256), (0, 256), (64, 1025), (64, 0)])
def test_launch_plans_refuse_what_the_kernels_cannot_take(kp, ct):
    from single_algebra_tpu_torch.ops import spmm_kernel as sk

    with pytest.raises(ValueError):
        sk._spmm_plan(16, ct, kp, torch.bfloat16, torch.bfloat16)
    with pytest.raises(ValueError):
        sk._rmv_plan(1024, kp, 4, ct)


def unswizzled(x, r, k):
    """Element k of row r of a swizzled operand block: unit u of row r
    lies at unit u ^ (r & m), m = min(units per row, 8) - 1."""

    per = 16 // x.element_size()
    m = min(x.shape[-1] // per, 8) - 1
    return ((k // per) ^ (r & m)) * per + k % per


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("kc", [16, 32, 64])
def test_spmm_operand_layout_is_plain_indexing(dt, kc):
    from single_algebra_tpu_torch.ops import spmm_kernel as sk

    kp, ntiles, ct = 56, 3, 24
    Bt = operand(30, kp, ntiles * ct, dt)
    lay = sk._spmm_operand(Bt, ntiles, ct, kc)
    nch = -(-kp // kc)
    assert lay.shape == (nch, ntiles, ct, kc) and lay.dtype == Bt.dtype and lay.is_contiguous()
    ch, t, c, k = np.meshgrid(np.arange(nch), np.arange(ntiles), np.arange(ct), np.arange(kc),
                              indexing="ij")
    got = lay[ch, t, c, unswizzled(lay, c, k)]
    row = ch * kc + k
    want = torch.where(torch.from_numpy(row < kp),
                       Bt[np.minimum(row, kp - 1), t * ct + c], torch.zeros((), dtype=Bt.dtype))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("kc", [32, 64])
def test_rmv_operand_layout_is_plain_indexing(dt, kc):
    from single_algebra_tpu_torch.ops import spmm_kernel as sk

    kp, R = 40, 72
    Ct = operand(31, kp, R, dt)
    lay = sk._rmv_operand(Ct, kc)
    nch = -(-kp // kc)
    assert lay.shape == (nch, R, kc) and lay.dtype == Ct.dtype and lay.is_contiguous()
    ch, r, k = np.meshgrid(np.arange(nch), np.arange(R), np.arange(kc), indexing="ij")
    got = lay[ch, r, unswizzled(lay, r, k)]
    row = ch * kc + k
    want = torch.where(torch.from_numpy(row < kp), Ct[np.minimum(row, kp - 1), r],
                       torch.zeros((), dtype=Ct.dtype))
    assert torch.equal(got, want)


@pytest.mark.parametrize("blocked", [False, True])
def test_ell_spmm_matches_jax(monkeypatch, blocked):
    import jax.numpy as jnp

    from single_algebra_tpu.ops.spmm import ell_spmm as jell

    rng = np.random.default_rng(15)
    R, W, p, k = 203, 16, 90, 6
    data = rng.random((R, W)).astype(np.float32)
    ids = rng.integers(0, p, (R, W)).astype(np.int32)
    data[:, 12:] = 0.0  # padding slots (0, 0)
    ids[:, 12:] = 0
    B = rng.standard_normal((p, k)).astype(np.float32)
    if blocked:  # several row blocks, the last one ragged
        monkeypatch.setattr(tspmm, "_GATHER_BUDGET", 40 * W * k)
    got = tspmm.ell_spmm(torch.from_numpy(data), torch.from_numpy(ids), torch.from_numpy(B))
    want = np.asarray(jell(jnp.asarray(data), jnp.asarray(ids), jnp.asarray(B)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    ref = np.einsum("rw,rwk->rk", data.astype(np.float64), B.astype(np.float64)[ids])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# -- the bucketed form of rmv --------------------------------------------------


def form_payload(seed, ntiles, wt, R, ct, dtype):
    """``payload`` plus the cases a form drops or keeps: stored-looking
    slots with ``v == 0`` and negative ids (dropped), duplicate ids (kept)."""

    vals, ids = payload(seed, ntiles, wt, R, ct, dtype=dtype, frac=dtype != "bf16")
    rng = np.random.default_rng(seed + 1)
    zero = torch.from_numpy(rng.random(vals.shape) < 0.03)
    vals[zero] = 0
    ids[zero] = torch.from_numpy(rng.integers(1, ct, vals.shape).astype(np.int32))[zero]
    ids[torch.from_numpy(rng.random(vals.shape) < 0.02)] = -1
    return vals, ids


def value_bits(vals):
    """Each value's bits as the form packs them: bf16 bits, f32 bits."""

    if vals.dtype == torch.bfloat16:
        return vals.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    return vals.view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


def form_by_loops(vals, ids, *, wt, ntiles, ct):
    """Item by item, the stored slots of each column in (slot // 16, row //
    32, slot % 16, row % 32) order, as (value bits, row in the item)."""

    R = vals.shape[1]
    nrc = -(-R // 256)
    bits, v, lid = value_bits(vals), vals.float().numpy(), ids.numpy()
    items = []
    for t in range(ntiles):
        for rc in range(nrc):
            cols = [[] for _ in range(ct)]
            for j0 in range(0, wt, 16):
                for warp in range(8):
                    for u in range(j0, min(j0 + 16, wt)):
                        for lane in range(32):
                            r = rc * 256 + warp * 32 + lane
                            x, c = (v[t * wt + u, r], lid[t * wt + u, r]) if r < R else (0, -1)
                            if x != 0 and 0 <= c < ct:
                                cols[c].append((int(bits[t * wt + u, r]), warp * 32 + lane))
            items.append(cols)
    return items


def decode_form(form):
    """The form's entries as (value bits, row) per item and column."""

    ct, n = form.col_tile, int(form.starts[-1])
    if form.dtype == torch.bfloat16:
        w = form.entries[:n].numpy().astype(np.int64) & 0xFFFFFFFF
        bits, rows = w >> 16, w & 0xFFFF
    else:
        w = form.entries[:2 * n].numpy().astype(np.int64).reshape(n, 2) & 0xFFFFFFFF
        bits, rows = w[:, 0], w[:, 1]
    ents = list(zip(bits.tolist(), rows.tolist()))
    off, starts = form.offsets.numpy(), form.starts.numpy()
    return [[ents[starts[i] + off[i, c]:starts[i] + off[i, c + 1]] for c in range(ct)]
            for i in range(len(starts) - 1)]


FORM_CASES = [  # (payload, wt, col_tile, R): partial last row chunks but for 1024
    ("bf16", 16, 64, 600),
    ("bf16", 8, 48, 1024),
    ("f32", 24, 64, 520),
    ("f32", 8, 300, 264),
]


@pytest.mark.parametrize("pdt, wt, ct, R", FORM_CASES)
def test_rmv_form_plain_holds_each_stored_slot_once_in_order(pdt, wt, ct, R):
    from single_algebra_tpu_torch.ops import spmm_kernel as sk

    ntiles = 2
    vals, ids = form_payload(40, ntiles, wt, R, ct, pdt)
    form = tiled_ell_rmv_form_plain(vals, ids, wt=wt, ntiles=ntiles, col_tile=ct)
    want = form_by_loops(vals, ids, wt=wt, ntiles=ntiles, ct=ct)
    # each stored slot once, by column, then in (j, warp, slot, lane) order
    assert decode_form(form) == want
    v = vals.float()
    stored = int(((v != 0) & (ids >= 0) & (ids < ct)).sum())
    words = 1 if pdt == "bf16" else 2
    assert int(form.starts[-1]) == stored and form.entries.shape == (stored * words + 4,)
    assert not form.entries[stored * words:].any()  # the 16 bytes of padding
    nrc = -(-R // 256)
    off = form.offsets
    assert off.dtype == torch.int32 and off.shape == (ntiles * nrc, -(-(ct + 1) // 4) * 4)
    counts = torch.tensor([sum(len(c) for c in item) for item in want])
    assert (off[:, 0] == 0).all() and (off[:, 1:] >= off[:, :-1]).all()
    assert (off[:, ct:] == counts[:, None]).all()
    assert form.starts.dtype == torch.int64 and form.starts[0] == 0
    assert torch.equal(form.starts[1:] - form.starts[:-1], counts)
    sched = form.schedule
    ng = -(-ct // 256)
    assert sched.dtype == torch.uint8 and sched.shape == (ntiles * nrc, ng, 256)
    assert form.nbytes == (stored * words * 4 + 16 + off.numel() * 4 + form.starts.numel() * 8
                           + sched.numel())
    # slot 16 w + S j + g of a group's schedule (S columns a warp step): its
    # (count, column)-descending i-th column, i = S (16 j + (w if j even else
    # 15 - w)) + g
    S = sk._RMV_SCHED_COLS
    i = np.arange(256)
    j, pos = i // (16 * S), (i // S) % 16
    slot = 16 * np.where(j % 2 == 1, 15 - pos, pos) + S * j + i % S
    col_counts = [[len(c) for c in item] + [0] * (ng * 256 - ct) for item in want]
    for it in range(ntiles * nrc):
        for cg in range(ng):
            cols = sched[it, cg].numpy().astype(np.int64)[slot]
            assert sorted(cols) == list(range(256))
            keys = [col_counts[it][cg * 256 + c] * 256 + c for c in cols]
            assert keys == sorted(keys, reverse=True)


@pytest.mark.parametrize("pdt, odt, kp", CASES + [("f32", "bf16", 40)])
def test_rmv_with_a_plain_form_matches_plain(pdt, odt, kp):
    ntiles, wt, ct, R = 3, 16, 128, 1024
    vals, ids = form_payload(41, ntiles, wt, R, ct, pdt)
    Ct = operand(42, kp, R, odt)
    kw = dict(wt=wt, ntiles=ntiles, col_tile=ct, block_rows=128)
    form = tiled_ell_rmv_form(vals, ids, wt=wt, ntiles=ntiles, col_tile=ct)  # the plain builder
    got = tiled_ell_rmv_t(vals, ids, Ct, form=form, **kw)
    want = tiled_ell_rmv_t_plain(vals, ids, Ct, **kw)
    # the CPU route checks a form and runs the plain version
    assert got.dtype == want.dtype == torch.float32 and torch.equal(got, want)


def test_rmv_refuses_another_payloads_form():
    vals, ids = payload(43, 2, 8, 256, 64)
    Ct = operand(44, 8, 256, "f32")
    kw = dict(wt=8, ntiles=2, col_tile=64, block_rows=128)
    form = tiled_ell_rmv_form_plain(vals, ids, wt=8, ntiles=2, col_tile=64)
    with pytest.raises(ValueError):  # another column tile
        tiled_ell_rmv_t(vals, ids, Ct, form=form, **dict(kw, col_tile=32, ntiles=2))
    with pytest.raises(ValueError):  # another payload dtype
        tiled_ell_rmv_t(vals.to(torch.bfloat16), ids, Ct, form=form, **kw)
    with pytest.raises(TypeError):
        tiled_ell_rmv_t(vals, ids, Ct, form=(form.entries, form.offsets), **kw)
    with pytest.raises(TypeError):  # float64 payloads have no form
        tiled_ell_rmv_form_plain(vals.double(), ids, wt=8, ntiles=2, col_tile=64)


def counts_matrix(seed, n, p, *, frac):
    """A sparse float32 count matrix with a few heavy rows (overflow on
    both sides of the tiled payload)."""

    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    X = sp.random(n, p, density=0.02, format="lil", random_state=rng,
                  data_rvs=lambda k: rng.integers(1, 9, k) + (rng.random(k) if frac else 0))
    for r in (10, 211, 400):
        X[r, 100:600] = rng.integers(1, 9, 500)
    return X.tocsr().astype(np.float32)


def payload_device_bytes(op):
    arrays = (op.tdata, op.tdata_lo, op.tlocal, op.ov_data, op.ov_ids, op.ovt_data, op.ovt_ids)
    return sum(a.numel() * a.element_size() for a in arrays if a is not None)


def test_bf16_payload_and_its_form_fit_payload_bytes():
    """The engine's capacity charge (8 bytes a slot, as the JAX package's)
    covers a bf16-exact payload (6 bytes a slot) and its rmv form."""

    from single_algebra_tpu_torch import SparseMatrix
    from single_algebra_tpu_torch.linalg.operators import TiledSparseOperator

    m = SparseMatrix.from_scipy(counts_matrix(45, 2000, 1400, frac=False), device="cpu")
    op = TiledSparseOperator.from_matrix(m)
    assert op.tdata.dtype == torch.bfloat16 and op.tdata_lo is None
    wt, nt, ct = op.meta[:3]
    form = tiled_ell_rmv_form_plain(op.tdata, op.tlocal, wt=wt, ntiles=nt, col_tile=ct)
    assert payload_device_bytes(op) + form.nbytes <= TiledSparseOperator.payload_bytes(m)


def tiled_matrix(seed, values):
    """``counts_matrix``: bf16-exact counts (a hi payload), fractional
    values (hi and lo), or with a denser layer, so that wt > 16 (float32)."""

    import scipy.sparse as sp

    X = counts_matrix(seed, 2000, 1400, frac=values == "frac")
    if values == "wide":
        rng = np.random.default_rng(seed + 1)
        X = (X + sp.random(2000, 1400, density=0.12, format="csr", random_state=rng,
                           data_rvs=rng.random)).tocsr().astype(np.float32)
    return X


@pytest.mark.parametrize("values", ["counts", "frac", "wide"])
def test_form_charge_covers_the_payload_and_its_forms(values):
    """What ``fits`` charges on a card, ``payload_bytes`` plus
    ``form_charge``, holds the payload and every rmv form the operator
    keeps: one of a hi-only or float32 payload, two of a hi and lo one."""

    from single_algebra_tpu_torch import SparseMatrix
    from single_algebra_tpu_torch.linalg.operators import TiledSparseOperator, form_charge
    from single_algebra_tpu_torch.ops.spmm_kernel import rmv_form_nbytes

    m = SparseMatrix.from_scipy(tiled_matrix(46, values), device="cpu")
    op = TiledSparseOperator.from_matrix(m)
    wt, nt, ct = op.meta[:3]
    kind = {"counts": (torch.bfloat16, False), "frac": (torch.bfloat16, True),
            "wide": (torch.float32, False)}[values]
    assert (op.tdata.dtype, op.tdata_lo is not None) == kind
    halves = [td for td in (op.tdata, op.tdata_lo) if td is not None]
    forms = [tiled_ell_rmv_form_plain(td, op.tlocal, wt=wt, ntiles=nt, col_tile=ct)
             for td in halves]
    R = op.tdata.shape[1]
    for f in forms:
        assert f.nbytes == rmv_form_nbytes(int(f.starts[-1]), R, nt, ct, f.dtype)
    charge = form_charge(m, wt, nt, R)
    held = payload_device_bytes(op) + sum(f.nbytes for f in forms)
    assert held <= TiledSparseOperator.payload_bytes(m) + charge
    if values != "counts":  # a payload with no slack is charged each form whole
        assert charge >= sum(f.nbytes for f in forms)
    # the CPU keeps no form, and plans as the JAX package does
    assert TiledSparseOperator.form_bytes(m) == 0
    assert TiledSparseOperator.fits(m, budget_bytes=TiledSparseOperator.payload_bytes(m))


def test_cpu_operator_builds_no_form():
    """On the CPU the operator's rmv runs the plain route: no form is kept
    and the ``tiled.rmv`` span says so."""

    from single_algebra_tpu_torch import SparseMatrix
    from single_algebra_tpu_torch.linalg.operators import TiledSparseOperator
    from single_algebra_tpu_torch.utils import tracing

    X = counts_matrix(46, 900, 700, frac=True)
    op = TiledSparseOperator.from_matrix(SparseMatrix.from_scipy(X, device="cpu"))
    C = torch.from_numpy(np.random.default_rng(47).standard_normal((900, 6)).astype(np.float32))
    with tracing.recording() as rec:
        got = op.rmv(C)
        op.rmv_fast(C)
    assert [s["attrs"]["form"] for s in rec.spans() if s["name"] == "tiled.rmv"] == ["none"] * 2
    assert op._forms == {}
    want = X.T.astype(np.float64) @ C.numpy().astype(np.float64)
    assert rel_err(got.numpy(), want) <= 1e-5


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


CUDA_CASES = [  # (payload, operand, wt, kp)
    ("bf16", "bf16", 16, 64),
    ("bf16", "f32", 16, 64),
    ("f32", "f32", 24, 64),
    ("bf16", "bf16", 16, 16),
    ("f32", "bf16", 8, 40),
    ("bf16", "bf16", 8, 8),
    ("bf16", "f32", 16, 56),
    ("f32", "f32", 8, 128),
    ("bf16", "bf16", 24, 128),
    ("f32", "bf16", 16, 56),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("pdt, odt, wt, kp", CUDA_CASES)
def test_cuda_kernels_match_plain(cuda, pdt, odt, wt, kp):
    ntiles, ct, R = 7, 256, 3 * 1024
    vals, ids = payload(16, ntiles, wt, R, ct, dtype=pdt, frac=pdt != "bf16")
    vals, ids = vals.to(cuda), ids.to(cuda)
    kw = dict(wt=wt, ntiles=ntiles, col_tile=ct)
    for fn, plain, op, name in (
        (tiled_ell_spmm_t, tiled_ell_spmm_t_plain, operand(17, kp, ntiles * ct, odt),
         "tiled_ell_spmm_t"),
        (tiled_ell_rmv_t, tiled_ell_rmv_t_plain, operand(18, kp, R, odt), "tiled_ell_rmv_t"),
    ):
        op = op.to(cuda)
        cuda_lib.reset_launch_counts()
        got = fn(vals, ids, op, **kw)
        torch.cuda.synchronize()
        assert cuda_lib.launch_counts[name] == 1
        want = plain(vals, ids, op, **kw)
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-5, (name, err)
        assert torch.equal(fn(vals, ids, op, **kw), got)  # no scheduling dependence


@pytest.mark.requires_cuda
def test_cuda_rmv_many_ranges(cuda):
    # enough rows for several row ranges (the fixed-order range reduction)
    ntiles, wt, ct, R = 2, 8, 128, 64 * 1024
    vals, ids = payload(19, ntiles, wt, R, ct, dtype="bf16", frac=False)
    Ct = operand(20, 64, R, "f32")
    vals, ids, Ct = vals.to(cuda), ids.to(cuda), Ct.to(cuda)
    from single_algebra_tpu_torch.ops.spmm_kernel import _rmv_plan

    assert _rmv_plan(R, 64, ntiles, ct).nranges > 1
    kw = dict(wt=wt, ntiles=ntiles, col_tile=ct)
    got = tiled_ell_rmv_t(vals, ids, Ct, **kw)
    want = tiled_ell_rmv_t_plain(vals, ids, Ct, **kw)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.requires_cuda
def test_cuda_kernels_refuse_what_they_do_not_take(cuda):
    vals, ids = payload(21, 2, 8, 256, 64)
    vals, ids = vals.to(cuda), ids.to(cuda)
    Bt = operand(22, 8, 128, "f32").to(cuda)
    kw = dict(wt=8, ntiles=2, col_tile=64, block_rows=128)
    with pytest.raises(TypeError):  # float64 payloads are refused
        tiled_ell_spmm_t(vals.double(), ids, Bt, **kw)
    with pytest.raises(TypeError):  # float64 operands are refused
        tiled_ell_spmm_t(vals, ids, Bt.double(), **kw)
    with pytest.raises(ValueError):  # a non-contiguous operand is refused
        tiled_ell_spmm_t(vals, ids, operand(23, 128, 8, "f32").to(cuda).T, **kw)
    with pytest.raises(ValueError):  # payload on the card, operand on the host
        tiled_ell_rmv_t(vals, ids, operand(24, 8, 256, "f32"), **kw)
    with pytest.raises(ValueError):  # R not a multiple of 8: no 16-byte row copies
        v, i = payload(26, 2, 8, 260, 64)
        tiled_ell_spmm_t(v.to(cuda), i.to(cuda), Bt, **dict(kw, block_rows=4))


@pytest.mark.requires_cuda
def test_cuda_operator_matches_cpu_operator(cuda):
    """TiledSparseOperator on the card (kernels) against the same operator
    on the CPU (plain versions): a bf16 hi + lo payload with overflow on
    both sides, kp 64."""

    import scipy.sparse as sp

    from single_algebra_tpu_torch import SparseMatrix
    from single_algebra_tpu_torch.linalg.operators import TiledSparseOperator

    rng = np.random.default_rng(25)
    X = sp.random(900, 700, density=0.02, format="lil", random_state=rng, data_rvs=rng.random)
    for r in (10, 211, 400, 401, 402):  # heavy rows: overflow entries
        X[r, 100:600] = rng.random(500)
    X = X.tocsr().astype(np.float32)
    cpu = TiledSparseOperator.from_matrix(SparseMatrix.from_scipy(X, device="cpu"))
    gpu = TiledSparseOperator.from_matrix(SparseMatrix.from_scipy(X, device=cuda))
    assert gpu.tdata_lo is not None and min(gpu.meta[4:]) > 0
    B = torch.from_numpy(rng.standard_normal((700, 60)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((900, 60)).astype(np.float32))
    cuda_lib.reset_launch_counts()
    for name, arg in (("mv", B), ("mv_fast", B), ("rmv", C), ("rmv_fast", C)):
        got = getattr(gpu, name)(arg.to(cuda)).cpu()
        want = getattr(cpu, name)(arg)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5, name
    assert cuda_lib.launch_counts["tiled_ell_spmm_t"] == 3  # hi + lo, then hi
    assert cuda_lib.launch_counts["tiled_ell_rmv_t"] == 3


CUDA_FORM_CASES = [  # (payload, wt, col_tile, R): slot chunks, column groups, partial chunks
    ("bf16", 16, 256, 3 * 1024),
    ("bf16", 24, 128, 2600),
    ("f32", 24, 256, 2600),
    ("f32", 8, 512, 1032),
    ("bf16", 40, 1024, 1536),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("pdt, wt, ct, R", CUDA_FORM_CASES)
def test_cuda_rmv_form_equals_the_plain_builders(cuda, pdt, wt, ct, R):
    ntiles = 5
    vals, ids = form_payload(50, ntiles, wt, R, ct, pdt)
    want = tiled_ell_rmv_form_plain(vals, ids, wt=wt, ntiles=ntiles, col_tile=ct)
    cuda_lib.reset_launch_counts()
    got = tiled_ell_rmv_form(vals.to(cuda), ids.to(cuda), wt=wt, ntiles=ntiles, col_tile=ct)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["tiled_ell_rmv_form"] == 1
    assert (got.dtype, got.R, got.ntiles, got.col_tile) == (want.dtype, R, ntiles, ct)
    for name in ("entries", "offsets", "starts", "schedule"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), name


CUDA_FORM_RMV_CASES = [  # (payload, operand, wt, kp, R, ntiles, col_tile)
    ("bf16", "bf16", 16, 64, 3 * 1024, 7, 256),
    ("bf16", "f32", 16, 64, 3 * 1024, 7, 256),
    ("f32", "f32", 24, 8, 3 * 1024, 7, 256),
    ("f32", "bf16", 8, 40, 3 * 1024, 7, 512),
    ("bf16", "bf16", 16, 16, 3 * 1024, 7, 128),
    ("bf16", "f32", 8, 56, 64 * 1024, 2, 128),  # several row ranges
    ("bf16", "bf16", 16, 64, 64 * 1024, 2, 256),
    ("f32", "f32", 24, 32, 64 * 1024, 2, 256),
    ("f32", "f32", 40, 64, 3 * 1024, 7, 256),  # more pieces a row chunk than piece stages
    ("bf16", "bf16", 64, 64, 3 * 1024, 7, 256),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("pdt, odt, wt, kp, R, ntiles, ct", CUDA_FORM_RMV_CASES)
def test_cuda_rmv_with_a_form_equals_rmv_without(cuda, pdt, odt, wt, kp, R, ntiles, ct):
    from single_algebra_tpu_torch.ops.spmm_kernel import _rmv_plan

    vals, ids = form_payload(51, ntiles, wt, R, ct, pdt)
    vals, ids = vals.to(cuda), ids.to(cuda)
    Ct = operand(52, kp, R, odt).to(cuda)
    kw = dict(wt=wt, ntiles=ntiles, col_tile=ct)
    if R > 8192:
        assert _rmv_plan(R, kp, ntiles, ct, Ct.dtype).nranges > 1
    form = tiled_ell_rmv_form(vals, ids, **kw)
    cuda_lib.reset_launch_counts()
    got = tiled_ell_rmv_t(vals, ids, Ct, form=form, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["tiled_ell_rmv_form"] == 0
    bare = tiled_ell_rmv_t(vals, ids, Ct, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["tiled_ell_rmv_form"] == 1
    assert cuda_lib.launch_counts["tiled_ell_rmv_t"] == 2
    assert torch.equal(got, bare)
    want = tiled_ell_rmv_t_plain(vals, ids, Ct, **kw)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    for _ in range(2):  # no scheduling dependence
        assert torch.equal(tiled_ell_rmv_t(vals, ids, Ct, form=form, **kw), got)


def _operators(route, X, cuda):
    """The tiled operator on the card and its CPU twin: from a matrix, or
    the second slab of a two-entry mesh."""

    from single_algebra_tpu_torch import SparseMatrix
    from single_algebra_tpu_torch.linalg.operators import TiledSparseOperator
    from single_algebra_tpu_torch.parallel.sharded import Mesh, ShardedTiled

    ops = []
    for dev in (cuda, torch.device("cpu")):
        m = SparseMatrix.from_scipy(X, device=dev)
        if route == "from_matrix":
            ops.append(TiledSparseOperator.from_matrix(m))
        else:
            ops.append(ShardedTiled.from_matrix(m, Mesh((dev,) * 2)).slabs[1])
    return ops


@pytest.mark.requires_cuda
@pytest.mark.parametrize("route", ["from_matrix", "mesh_slab"])
def test_cuda_operator_buckets_each_half_once(cuda, route):
    from single_algebra_tpu_torch.linalg.operators import CenteredOperator
    from single_algebra_tpu_torch.utils import tracing

    X = counts_matrix(53, 1800, 700, frac=True)
    gpu, cpu = _operators(route, X, cuda)
    assert gpu.tdata_lo is not None
    C = torch.from_numpy(np.random.default_rng(54).standard_normal(
        (gpu.shape[0], 24)).astype(np.float32))
    centered = CenteredOperator(gpu, torch.zeros(gpu.shape[1], device=cuda))
    calls = [("rmv_fast", gpu.rmv_fast), ("rmv", gpu.rmv),
             ("rmv_precise", centered.rmv_precise), ("rmv_fast", gpu.rmv_fast),
             ("rmv", gpu.rmv)]
    cuda_lib.reset_launch_counts()
    with tracing.recording() as rec:
        got = [fn(C.to(cuda)) for _, fn in calls]
        torch.cuda.synchronize()
    assert cuda_lib.launch_counts["tiled_ell_rmv_form"] == 2  # hi, then lo
    assert cuda_lib.launch_counts["tiled_ell_rmv_t"] == 1 + 2 + 2 + 1 + 2
    forms = [s["attrs"]["form"] for s in rec.spans() if s["name"] == "tiled.rmv"]
    assert forms == ["built", "built", "reused", "reused", "reused"]
    assert set(gpu._forms) == {"hi", "lo"}
    want = {"rmv_fast": cpu.rmv_fast(C), "rmv": cpu.rmv(C),
            "rmv_precise": CenteredOperator(cpu, torch.zeros(cpu.shape[1])).rmv_precise(C)}
    for (name, _), out in zip(calls, got):
        err = float((out.cpu() - want[name]).abs().max() / want[name].abs().max())
        assert err <= 1e-5, (name, err)
    assert torch.equal(got[0], got[3]) and torch.equal(got[1], got[4])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("values", ["frac", "wide"])
def test_cuda_operator_forms_fit_what_fits_charges(cuda, values):
    """A hi and lo payload and a float32 one keep forms past the 8-byte
    charge: ``fits`` charges them, and what the card holds after ``rmv``
    (both halves' forms) stays within that charge."""

    from single_algebra_tpu_torch import SparseMatrix
    from single_algebra_tpu_torch.linalg.operators import TiledSparseOperator

    m = SparseMatrix.from_scipy(tiled_matrix(56, values), device=cuda)
    op = TiledSparseOperator.from_matrix(m)
    op.rmv(torch.ones((2000, 8), device=cuda))
    assert set(op._forms) == ({"hi", "lo"} if values == "frac" else {"hi"})
    held = payload_device_bytes(op) + sum(f.nbytes for f in op._forms.values())
    payload, forms = TiledSparseOperator.payload_bytes(m), TiledSparseOperator.form_bytes(m)
    assert forms > 0
    assert held <= payload + forms
    assert TiledSparseOperator.fits(m, budget_bytes=payload + forms)
    assert not TiledSparseOperator.fits(m, budget_bytes=payload + forms - 1)


@pytest.mark.requires_cuda
def test_cuda_bf16_operator_and_its_form_fit_payload_bytes(cuda):
    from single_algebra_tpu_torch import SparseMatrix
    from single_algebra_tpu_torch.linalg.operators import TiledSparseOperator

    m = SparseMatrix.from_scipy(counts_matrix(55, 2000, 1400, frac=False), device=cuda)
    op = TiledSparseOperator.from_matrix(m)
    op.rmv_fast(torch.ones((2000, 8), device=cuda))
    assert op.tdata_lo is None and set(op._forms) == {"hi"}
    held = payload_device_bytes(op) + op._forms["hi"].nbytes
    assert held <= TiledSparseOperator.payload_bytes(m)
