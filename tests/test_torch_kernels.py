"""The port's two kernel modules against the JAX reference, on the CPU.

For seeded admission / megastep problems, these must agree field by field
and dtype by dtype:

  * the JAX definitional oracles (``repro.kernels.ref``),
  * the JAX package's CPU lowerings (``repro.kernels.ops`` off the TPU:
    the gate, ``residual_fcfs`` and ``megastep_effect_products``), and the
    Pallas kernels themselves in interpret mode wherever the installed
    JAX's Pallas still interprets them (its ``pl.load``/``pl.store`` API),
  * the port's torch oracles (``repro_torch.kernels.ref``),
  * the port's plain pipelines (``repro_torch.kernels.ops`` on CPU
    tensors: the gate, the residual walk, the settle and the effect
    products),
  * a plain-torch mirror of the CUDA walk's decomposition
    (``csrc/residual_walk.cuh``): tiles of T transactions, a compact table
    of the cells each tile names, ``need`` computed before the walk, the
    serial walk over the table, the write-back, at T = 1, 3 and >= B.

Tolerance: exact. Every output is an integer, a bool, or a float32 product
of two exact operands.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.escrow_admit import (  # noqa: E402
    contention_gate as j_gate, escrow_admit_kernel,
    residual_fcfs as jresidual_fcfs, residual_order as j_order)
from repro.kernels.txn_megastep import txn_megastep_kernel  # noqa: E402
from repro.core.lattice import hot_position as j_hot_position  # noqa: E402
from repro_torch.core.lattice import hot_position  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.escrow_admit import (  # noqa: E402
    WALK_SMEM_BUDGET, contention_gate, residual_fcfs, residual_order,
    walk_hash, walk_shape, walk_smem_bytes, walk_table_size)
from repro_torch.kernels.txn_megastep import MegastepOut  # noqa: E402

BIG = np.iinfo(np.int32).max // 2


def _problem(seed, B=16, L=6, A=48, n_keys=12, n_cells=40, lo=0, hi=40,
             dup_heavy=False, zero_frac=0.0, sentinel=False,
             one_cell=False):
    """A seeded megastep problem (the admission problem plus district keys,
    local cells, the local/remote split, stamps and prices), shaped like
    the reference's ``_mega_problem``. ``zero_frac`` zeroes that share of
    the headroom; ``sentinel`` makes the last cell the BIG remote-cold
    sentinel and routes a fifth of the lines to it; ``one_cell`` makes
    every valid line of every fourth transaction name one cell."""
    rng = np.random.default_rng(seed)
    avail0 = rng.integers(lo, hi + 1, A).astype(np.int32)
    avail0[rng.random(A) < zero_frac] = 0
    cells = max(2, A // 4) if dup_heavy else A
    slot = rng.integers(0, cells, (B, L)).astype(np.int32)
    if sentinel:
        avail0[-1] = BIG
        slot = np.where(rng.random((B, L)) < 0.2, A - 1, slot).astype(
            np.int32)
    lv = rng.random((B, L)) < 0.85
    if one_cell:
        slot[::4] = slot[::4, :1]
    loc = (rng.random((B, L)) < 0.7) & lv
    return dict(
        avail0=avail0, slot=slot,
        qty=rng.integers(1, 11, (B, L)).astype(np.int32), line_valid=lv,
        key_local=rng.integers(0, n_keys, B).astype(np.int32),
        cell_local=np.where(loc, rng.integers(0, n_cells, (B, L)),
                            0).astype(np.int32),
        local_line=loc, remote_line=(rng.random((B, L)) < 0.3) & lv,
        ramp_ts=rng.integers(0, 1 << 20, B).astype(np.int32),
        price_row=rng.integers(1, 100, (B, L)).astype(np.float32),
    ), dict(n_keys=n_keys, n_cells=n_cells)


CASES = {
    "scarce": dict(hi=12),
    "plump_all_fast": dict(lo=300, hi=500),
    "dup_heavy": dict(dup_heavy=True, hi=50),
    "mixed": dict(B=32, L=8, A=80, n_keys=6, n_cells=24, hi=60),
    "zero_headroom_big_sentinel": dict(zero_frac=0.3, sentinel=True, hi=30),
    "heavy_contention": dict(B=24, L=15, A=12, hi=20),
    "one_cell_transactions": dict(one_cell=True, hi=40),
}


def _interpretable() -> bool:
    """Whether this JAX's Pallas can run the reference kernels in interpret
    mode (they are written against ``pl.load``/``pl.store``)."""
    return hasattr(pl, "load")


def _jax(p):
    return tuple(jnp.asarray(v) for v in p.values())


def _torch(p):
    return tuple(torch.from_numpy(v) for v in p.values())


def _to_torch(xs):
    return tuple(torch.tensor(np.asarray(x)) for x in xs)


def _assert_same(want, got, tag):
    assert len(want) == len(got), tag
    names = MegastepOut._fields if len(want) == 9 else range(len(want))
    for name, x, y in zip(names, want, got):
        x = np.asarray(x)
        y = y.numpy()
        assert x.dtype == y.dtype, f"{tag}: {name} {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{tag}: {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_escrow_admit_matches_reference(case):
    p, _ = _problem(sorted(CASES).index(case), **CASES[case])
    j = _jax(p)[:4]
    t = _torch(p)[:4]
    want = jref.escrow_admit_ref(*j)
    _assert_same(want, _to_torch(jops.escrow_admit(*j)), "jax lowering")
    fast, _, _ = j_gate(*j)
    res_idx, n_res = j_order(fast)
    if _interpretable():
        # the Pallas kernel in interpret mode, plus the fast-path settle
        c_k, a_k = escrow_admit_kernel(*j, fast, res_idx, n_res,
                                       interpret=True)
        adm = j[3] & fast[:, None]
        a_k = a_k.at[jnp.where(adm, j[1], 0)].add(-jnp.where(adm, j[2], 0))
        _assert_same(want, _to_torch((c_k, a_k)), "pallas interpret")

    for tag, got in (("torch oracle", ref.escrow_admit_ref(*t)),
                     ("plain pipeline", ops.escrow_admit(*t))):
        _assert_same(want, got, tag)
    if case == "plump_all_fast":
        assert int(n_res[0]) == 0
    if case in ("scarce", "heavy_contention"):
        assert not bool(np.asarray(want[0]).all())   # aborts happened


@pytest.mark.parametrize("case", sorted(CASES))
def test_gate_and_residual_walk_match_reference(case):
    p, _ = _problem(sorted(CASES).index(case), **CASES[case])
    j = _jax(p)[:4]
    t = _torch(p)[:4]
    jf, jd, ju = j_gate(*j)
    tf, td, tu = contention_gate(*t)
    _assert_same((jf, jd, ju), (tf, td, tu), "gate")
    jr, jn = j_order(jf)
    tr, tn = residual_order(tf)
    _assert_same((jr, jn), (tr, tn), "residual_order")
    want = jresidual_fcfs(*j, jf, jr, jn)
    _assert_same(want, residual_fcfs(*t, tf, tr, tn), "residual walk")
    if _interpretable():
        _assert_same(want, _to_torch(escrow_admit_kernel(
            *j, jf, jr, jn, interpret=True)), "pallas interpret walk")


def _tiled_walk(avail0, slot, qty, line_valid, fast, res_idx, n_res, T):
    """The CUDA walk's decomposition in plain torch: the residual window in
    tiles of ``T`` transactions; per tile the staged lines (slot, or -1 for
    an invalid line), ``need`` = the transaction's earlier quantities on
    the slot plus its own, a flag on each transaction's last line on a
    slot, the compact table of the tile's distinct cells and each line's
    entry in it; then the serial walk over the table alone, where a commit
    stores have - need from the last line on each slot; then the
    write-back of the table and the verdicts."""
    L = slot.shape[1]
    avail = avail0.clone()
    committed = fast.clone()
    n = int(n_res[0])
    before = torch.ones((L, L), dtype=torch.bool).tril(-1)   # [l, j]: j < l
    for tile0 in range(0, n, T):
        t = res_idx[tile0:min(n, tile0 + T)].long()
        s = torch.where(line_valid[t], slot[t], -1)
        q = qty[t]
        v = s >= 0
        same = (s[:, :, None] == s[:, None, :]) & v[:, None, :]
        need = torch.where(same & before, q[:, None, :], 0).sum(
            2, dtype=torch.int32) + q
        last = ~(same & before.T).any(2)
        cells, inverse = torch.unique(s[v], return_inverse=True)
        entry = torch.full(s.shape, -1, dtype=torch.long)
        entry[v] = inverse
        table = avail[cells.long()]
        verdict = torch.zeros(len(t), dtype=torch.bool)
        for i in range(len(t)):
            e, w = entry[i][v[i]], entry[i][v[i] & last[i]]
            ok = bool((need[i][v[i]] <= table[e]).all())
            if ok:
                table[w] = table[w] - need[i][v[i] & last[i]]
            verdict[i] = ok
        avail[cells.long()] = table
        committed[t] = verdict
    return committed, avail


@pytest.mark.parametrize("T", [1, 3, 1 << 20])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_walk_mirror_matches_reference(case, T):
    """Tiles of 1 and 3 put tile boundaries inside runs of contended
    transactions (each tile then gathers the cells the one before it
    reserved); a tile of at least B is the main path's single tile."""
    p, _ = _problem(sorted(CASES).index(case), **CASES[case])
    j = _jax(p)[:4]
    t = _torch(p)[:4]
    jf, _, _ = j_gate(*j)
    jr, jn = j_order(jf)
    want = jresidual_fcfs(*j, jf, jr, jn)
    tf, _, _ = contention_gate(*t)
    tr, tn = residual_order(tf)
    _assert_same(want, residual_fcfs(*t, tf, tr, tn), "residual walk")
    _assert_same(want, _tiled_walk(*t, tf, tr, tn, T), f"tiled T={T}")
    if case in ("scarce", "heavy_contention") and T < 1 << 20:
        assert int(tn[0]) > 2 * T        # several tiles were walked


def test_walk_shape_fits_the_budget():
    """The main path's B = 256, L = 15 is one tile; a larger batch takes
    the most transactions a tile that fit the shared memory it asks for,
    and the table holds at least twice a tile's lines."""
    assert walk_shape(256, 15) == (256, 8192, walk_smem_bytes(256, 15))
    for B, L in ((1024, 15), (4096, 32), (1, 1), (7, 32)):
        T, H, smem = walk_shape(B, L)
        assert 1 <= T <= B and smem <= WALK_SMEM_BUDGET
        assert H == walk_table_size(T * L) >= 2 * T * L and H & (H - 1) == 0
        assert T == B or walk_smem_bytes(T + 1, L) > WALK_SMEM_BUDGET
    assert walk_shape(1024, 15)[0] < 1024


@pytest.mark.parametrize("H", [32, 8192])
def test_walk_hash_scatters_runs_of_neighbours(H):
    """The table's first probe lies in [0, H), is Fibonacci hashing's top
    bits (0x9E3779B9 = 2**32 / phi), and sends a run of H // 2 neighbouring
    slots, like one warehouse's hot items, to distinct entries, where
    ``slot mod H`` keeps them in one run for linear probing to pile up."""
    run = np.arange(1000, 1000 + H // 2, dtype=np.int64)
    h = walk_hash(run, H)
    assert h.min() >= 0 and h.max() < H
    assert walk_hash(1, H) == (0x9E3779B9 >> (32 - int(np.log2(H))))
    assert len(np.unique(h)) == H // 2
    assert np.diff(np.sort(h)).min() >= 1 and np.abs(np.diff(h)).min() > 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_megastep_matches_reference(case):
    p, kw = _problem(50 + sorted(CASES).index(case), **CASES[case])
    j = _jax(p)
    t = _torch(p)
    want = jref.txn_megastep_ref(*j, **kw)
    _assert_same(want, _to_torch(jops.txn_megastep(*j, **kw)),
                 "jax lowering")
    if _interpretable():
        fast, _, _ = j_gate(*j[:4])
        res_idx, n_res = j_order(fast)
        _assert_same(want, _to_torch(txn_megastep_kernel(
            *j[:4], fast, res_idx, n_res, *j[4:], **kw, interpret=True)),
            "pallas interpret")
    for tag, got in (
            ("torch oracle", ref.txn_megastep_ref(*t, **kw)),
            ("plain pipeline", ops.txn_megastep(*t, **kw))):
        _assert_same(want, got, tag)


@pytest.mark.parametrize("K", [0, 1, 7])
def test_hot_position_matches_reference(K):
    rng = np.random.default_rng(K)
    keys = np.sort(rng.choice(200, K, replace=False)).astype(np.int32)
    query = rng.integers(-5, 210, (9, 4)).astype(np.int32)
    if K:
        query[0, :2] = keys[[0, -1]]                 # exact hits at the ends
    jp, jh = j_hot_position(jnp.asarray(keys), jnp.asarray(query))
    tp, th = hot_position(torch.from_numpy(keys), torch.from_numpy(query))
    _assert_same((jp, jh), (tp, th), f"hot_position K={K}")
    if K == 0:
        assert not th.any()
