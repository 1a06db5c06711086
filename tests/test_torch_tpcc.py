"""The port's TPC-C New-Order (``repro_torch.txn.tpcc``, ``audit``,
``core``) against the JAX reference on shared seeded inputs, on the CPU.

Tolerance: exact (values and dtypes) for every output and every state
field. The float32 sums are exact because both packages take them in the
same order: ``s_ytd``'s addends are integers; the per-transaction total
and Delivery's credit sum an order's lines in line order; Payment's
scatter-adds land in batch order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.lattice import HotSetEscrow as JHotSetEscrow  # noqa: E402
from repro.core.planner import plan as jplan  # noqa: E402
from repro.txn import audit as jaudit  # noqa: E402
from repro.txn import tpcc as jt  # noqa: E402
from repro_torch.convert import (batch_from_numpy, escrow_from_numpy,  # noqa: E402
                                 payment_batch_from_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.core.lattice import HotSetEscrow  # noqa: E402
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.txn import audit as taudit  # noqa: E402
from repro_torch.txn import tpcc as tt  # noqa: E402

CPU = "cpu"
SMALL = dict(n_warehouses=2, districts=2, customers=8, n_items=64,
             order_capacity=256, max_lines=15)


def _mismatches(ref, port):
    """Fields whose dtype, shape or value differ (port side as numpy)."""
    ref = jax.device_get(ref)
    port = state_to_numpy(port)
    bad = []
    for name, x, y in zip(ref._fields, ref, port):
        x = np.asarray(x)
        if x.dtype != y.dtype or x.shape != y.shape or \
                not np.array_equal(x, y):
            bad.append(name)
    return bad


def _np(x):
    return np.asarray(jax.device_get(x))


@pytest.mark.parametrize("seed", [0, 3])
def test_init_state_matches_reference(seed):
    ref = jt.init_state(jt.TPCCScale(), seed=seed)
    port = tt.init_state(tt.TPCCScale(), seed=seed, device=CPU)
    assert _mismatches(ref, port) == []
    # the converter route lands on the same state
    assert _mismatches(ref, state_from_numpy(jax.device_get(ref), CPU)) == []


@pytest.mark.parametrize("item_skew", [0.0, 1.2])
def test_generate_neworder_matches_reference(item_skew):
    kw = dict(remote_frac=0.2, ts0=7, item_skew=item_skew)
    ref = jt.generate_neworder(np.random.default_rng(1), jt.TPCCScale(), 64,
                               **kw)
    port = tt.generate_neworder(np.random.default_rng(1), tt.TPCCScale(), 64,
                                device=CPU, **kw)
    assert _mismatches(ref, port) == []
    assert _mismatches(ref, batch_from_numpy(jax.device_get(ref), CPU)) == []


def test_apply_neworder_matches_reference_over_batches():
    """N seeded batches at the default TPCCScale(), merge regime."""
    scale, tscale = jt.TPCCScale(), tt.TPCCScale()
    ref = jt.init_state(scale, seed=2)
    port = tt.init_state(tscale, seed=2, device=CPU)
    step = jax.jit(lambda s, b: jt.apply_neworder(s, b, scale))
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(5):
        jb = jt.generate_neworder(r1, scale, 48, remote_frac=0.1, ts0=48 * i)
        tb = tt.generate_neworder(r2, tscale, 48, remote_frac=0.1,
                                  ts0=48 * i, device=CPU)
        ref, jd, jtot = step(ref, jb)
        port, td, ttot = tt.apply_neworder(port, tb, tscale)
        assert _mismatches(jd, td) == [], i
        np.testing.assert_array_equal(_np(jtot), ttot.numpy())
    assert _mismatches(ref, port) == []


@pytest.mark.parametrize("effects", ["scan", "fused"])
@pytest.mark.parametrize("admission", ["scan", "kernel"])
def test_escrow_sparse_matches_reference(admission, effects):
    """The strict-stock sparse New-Order, step by step: state, spent,
    outbox, committed mask and totals bit-equal, on a stream
    with hot, cold-local and cold-remote lines where some transactions
    commit and some abort."""
    scale = jt.TPCCScale(**SMALL)
    tscale = tt.TPCCScale(**SMALL)
    ref = jt.init_state(scale, seed=1)
    ref = ref._replace(s_quantity=ref.s_quantity * 2)
    port = state_from_numpy(jax.device_get(ref), CPU)
    keys = jt.select_hot_cells(scale, 4)
    shares = np.asarray(ref.s_quantity).reshape(-1)[keys]
    jk, jsh = jnp.asarray(keys), jnp.asarray(shares)
    tk, tsh = torch.from_numpy(keys), torch.from_numpy(shares.copy())
    jsp, tsp = jnp.zeros_like(jsh), torch.zeros_like(tsh)
    step = jax.jit(lambda s, sp, b: jt.apply_neworder_escrow_sparse(
        s, jk, jsh, sp, b, scale, admission=admission, effects=effects))
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    commits = aborts = 0
    for i in range(6):
        kw = dict(remote_frac=0.3, ts0=16 * i, item_skew=1.1)
        jb = jt.generate_neworder(r1, scale, 16, **kw)
        tb = tt.generate_neworder(r2, tscale, 16, device=CPU, **kw)
        ref, jsp, jd, jtot, jc = step(ref, jsp, jb)
        port, tsp, td, ttot, tc = tt.apply_neworder_escrow_sparse(
            port, tk, tsh, tsp, tb, tscale, admission=admission,
            effects=effects)
        np.testing.assert_array_equal(_np(jsp), tsp.numpy())
        np.testing.assert_array_equal(_np(jc), tc.numpy())
        assert tsp.dtype == torch.int32 and tc.dtype == torch.bool
        assert _mismatches(jd, td) == [], i
        np.testing.assert_array_equal(_np(jtot), ttot.numpy())
        commits += int(tc.sum())
        aborts += int((~tc).sum())
    assert _mismatches(ref, port) == []
    assert commits > 0 and aborts > 0


@pytest.mark.parametrize("path", ["merge", "escrow_scan", "escrow_fused"])
def test_neworder_totals_match_reference_exactly(path):
    """The per-transaction totals New-Order returns to the client, bit for
    bit, over five seeds: a row sum in line order, as XLA takes it
    (``torch.sum`` over the lines reassociates and was off in the last
    bits)."""
    scale, tscale = jt.TPCCScale(**SMALL), tt.TPCCScale(**SMALL)
    keys = jt.select_hot_cells(scale, 4)
    for seed in range(5):
        ref = jt.init_state(scale, seed=seed)
        port = state_from_numpy(jax.device_get(ref), CPU)
        rng = np.random.default_rng(seed)
        jb = jt.generate_neworder(rng, scale, 64, remote_frac=0.1,
                                  item_skew=0.5)
        tb = batch_from_numpy(jax.device_get(jb), CPU)
        if path == "merge":
            jtot = jt.apply_neworder(ref, jb, scale)[2]
            ttot = tt.apply_neworder(port, tb, tscale)[2]
        else:
            effects = path.split("_")[1]
            shares = np.asarray(ref.s_quantity).reshape(-1)[keys]
            jtot = jt.apply_neworder_escrow_sparse(
                ref, jnp.asarray(keys), jnp.asarray(shares),
                jnp.zeros_like(jnp.asarray(shares)), jb, scale,
                effects=effects)[3]
            ttot = tt.apply_neworder_escrow_sparse(
                port, torch.from_numpy(keys), torch.from_numpy(shares.copy()),
                torch.zeros(len(keys), dtype=torch.int32), tb, tscale,
                effects=effects)[3]
        assert ttot.dtype == torch.float32
        np.testing.assert_array_equal(_np(jtot), ttot.numpy(), err_msg=seed)
        assert float(ttot.abs().sum()) > 0


@pytest.mark.parametrize("gen", ["payment", "order_status", "stock_level"])
def test_mix_generators_match_reference(gen):
    """Draw for draw: the batch, and the rng's state after it."""
    r1, r2 = np.random.default_rng(8), np.random.default_rng(8)
    kw = dict(w_lo=1, w_hi=3)
    scale = jt.TPCCScale(n_warehouses=4)
    ref = getattr(jt, f"generate_{gen}")(r1, scale, 40, **kw)
    port = getattr(tt, f"generate_{gen}")(r2, tt.TPCCScale(n_warehouses=4),
                                          40, device=CPU, **kw)
    assert type(port).__name__ == type(ref).__name__
    assert _mismatches(ref, port) == []
    assert r1.integers(1 << 30) == r2.integers(1 << 30)


def _ordered(seed):
    """A state after three New-Order batches, on both sides."""
    scale = jt.TPCCScale(**SMALL)
    ref = jt.init_state(scale, seed=seed)
    rng = np.random.default_rng(seed)
    for i in range(3):
        ref = jt.apply_neworder(ref, jt.generate_neworder(
            rng, scale, 16, ts0=16 * i), scale)[0]
    return scale, rng, ref, state_from_numpy(jax.device_get(ref), CPU)


def test_apply_payment_matches_reference():
    """Duplicate-heavy Payments: 64 a batch into 2 warehouses x 2 districts
    x 8 customers."""
    scale, rng, ref, port = _ordered(12)
    pay = jax.jit(jt.apply_payment)
    for _ in range(3):
        jb = jt.generate_payment(rng, scale, 64)
        ref = pay(ref, jb)
        port = tt.apply_payment(port, payment_batch_from_numpy(
            jax.device_get(jb), CPU))
        assert _mismatches(ref, port) == []
    assert float(port.w_ytd.sum()) > 0
    assert int(port.c_payment_cnt.max()) > 2       # duplicates landed


def test_apply_delivery_matches_reference():
    """Deliveries until every district runs dry: a district with no
    undelivered order (an all-invalid argmin) is left alone on both
    sides; concealed lines are credited through the prepared layer."""
    scale, rng, ref, port = _ordered(13)
    from repro.txn import ramp as jramp
    drop = rng.random(ref.ol_vis.shape) < 0.5
    ref = jramp.conceal_lines(ref, jnp.asarray(drop))
    port = port._replace(ol_vis=port.ol_vis & ~torch.from_numpy(drop))
    # district (1, 1) has nothing to deliver from the start
    no_valid = np.array(ref.no_valid)
    no_valid[1, 1] = False
    ref = ref._replace(no_valid=jnp.asarray(no_valid))
    port.no_valid[1, 1] = False
    deliver = jax.jit(jt.apply_delivery)
    one, zero = jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32)
    for _ in range(int(no_valid.sum(-1).max()) + 1):
        ref = deliver(ref, one, zero)
        port = tt.apply_delivery(port, 1, 0)
        assert _mismatches(ref, port) == []
    assert not bool(port.no_valid.any())
    assert float(port.c_delivered_sum.sum()) > 0
    assert int(port.c_delivery_cnt.sum()) == int(no_valid.sum())


def test_strict_tiered_drain_matches_reference():
    """The owner-side strict drain: hot entries land, cold cells land
    all-or-nothing; the reject count and the state agree."""
    scale = jt.TPCCScale(**SMALL)
    ref = jt.init_state(scale, seed=4)
    port = state_from_numpy(jax.device_get(ref), CPU)
    keys = jt.select_hot_cells(scale, 4)
    rng = np.random.default_rng(11)
    R = 200
    cols = dict(dst_w=rng.integers(0, 2, R), i_idx=rng.integers(0, 64, R),
                qty=rng.integers(1, 40, R), mask=rng.random(R) < 0.8,
                remote=rng.random(R) < 0.5)
    cols = {k: v.astype(np.int32) if v.dtype != np.bool_ else v
            for k, v in cols.items()}
    ref, jr = jt.apply_stock_updates_strict_tiered(
        ref, jnp.asarray(keys), *(jnp.asarray(v) for v in cols.values()),
        n_items=64)
    port, tr = tt.apply_stock_updates_strict_tiered(
        port, torch.from_numpy(keys),
        *(torch.from_numpy(v) for v in cols.values()), n_items=64)
    assert int(jr) == int(tr) > 0 and tr.dtype == torch.int32
    assert _mismatches(ref, port) == []


# The stock scatter's oracle: the index_put_(accumulate=True) form it
# replaced, every masked lane adding zero at cell (0, 0).


def _put_stock_updates(state, w_idx, i_idx, qty, mask, remote, restock):
    idx = (torch.where(mask, w_idx, 0).long(),
           torch.where(mask, i_idx, 0).long())
    qty_m = torch.where(mask, qty, 0)
    state.s_ytd.index_put_(idx, qty_m.to(state.s_ytd.dtype), accumulate=True)
    state.s_order_cnt.index_put_(idx, mask.to(torch.int32), accumulate=True)
    state.s_remote_cnt.index_put_(idx, (mask & remote).to(torch.int32),
                                  accumulate=True)
    s_q = state.s_quantity
    s_q.index_put_(idx, -qty_m, accumulate=True)
    if restock:
        deficit = torch.ceil((10 - s_q) / 91.0).clamp_min(0).to(torch.int32)
        s_q.copy_(torch.where(s_q < 10, s_q + deficit * 91, s_q))


def _put_strict_tiered(state, hot_keys, dst_w, i_idx, qty, mask, remote,
                       n_items, w_lo):
    _, is_hot = tt.hot_position(hot_keys, dst_w * n_items + i_idx)
    w_idx = torch.where(mask, dst_w - w_lo, 0)
    i_idx = torch.where(mask, i_idx, 0)
    cold = mask & ~is_hot
    demand = torch.zeros_like(state.s_quantity)
    demand.index_put_((torch.where(cold, w_idx, 0).long(),
                       torch.where(cold, i_idx, 0).long()),
                      torch.where(cold, qty, 0), accumulate=True)
    admit_cold = cold & (demand <= state.s_quantity)[w_idx.long(),
                                                     i_idx.long()]
    _put_stock_updates(state, w_idx, i_idx, qty,
                       (mask & is_hot) | admit_cold, remote, False)
    return (cold & ~admit_cold).sum().to(torch.int32)


STOCK = ("s_quantity", "s_ytd", "s_order_cnt", "s_remote_cnt")
# name -> (warehouses, items, lanes, live share, owners, drain): "restock"
# and "strict-stock" are apply_stock_updates with and without the restock
# pass, "one cell" the latter with every live lane on one cell, "tiered"
# the strict tiered drain (hot keys, cold cells that fit and cells that
# do not)
SCATTERS = {
    "ring 1% live": (16, 4096, 8 * 256 * 15, 0.01, 1, "restock"),
    "ring 1% live, strict stock": (16, 4096, 8 * 256 * 15, 0.01, 1,
                                   "strict-stock"),
    "live duplicates": (4, 64, 3000, 0.5, 1, "one cell"),
    "more lanes than cells": (2, 8, 500, 0.5, 1, "restock"),
    "every lane masked": (4, 64, 600, 0.0, 1, "restock"),
    "shard view R=4": (16, 512, 8 * 64 * 15, 0.3, 4, "restock"),
    "strict tiered": (8, 256, 4000, 0.6, 1, "tiered"),
    "strict tiered R=4": (16, 128, 4000, 0.6, 4, "tiered"),
}


def _stock_state(W, I, rng):
    """A state whose stock columns hold seeded values: stock low enough
    that cold cells overflow, s_ytd integer-valued and never -0.0."""
    state = tt.init_state(tt.TPCCScale(n_warehouses=W, districts=1,
                                       customers=2, n_items=I,
                                       order_capacity=2), device=CPU)
    for name, hi in zip(STOCK, (30, 5000, 50, 9)):
        x = getattr(state, name)
        x.copy_(torch.from_numpy(rng.integers(0, hi, (W, I))).to(x.dtype))
    return state


@pytest.mark.parametrize("case", list(SCATTERS))
def test_stock_scatter_equals_the_sorted_put(case):
    """``apply_stock_updates`` (``index_add_`` on flat views, a masked lane
    adding zero at a cell of its own) and the strict drain over it give
    the stock columns of the ``index_put_(accumulate=True)`` form bit for
    bit, ``s_ytd`` included: a drain's whole ring with 1% live lanes, live
    lanes all on one cell, more lanes than cells, every lane masked, each
    owner's shard view at R = 4, the strict tiered drain at R = 1 and 4."""
    from repro_torch.txn.engine import shard_view

    W, I, N, live, owners, drain = SCATTERS[case]
    rng = np.random.default_rng(list(SCATTERS).index(case))
    got = _stock_state(W, I, rng)
    before, want = tt.copy_tree(got), tt.copy_tree(got)
    draw = lambda hi: torch.from_numpy(  # noqa: E731
        rng.integers(0, hi, N).astype(np.int32))
    dst_w, i_id, qty = draw(W), draw(I), draw(10) + 1
    if drain == "one cell":
        dst_w.fill_(W - 1)
        i_id.fill_(I // 2)
    valid = torch.from_numpy(rng.random(N) < live)
    remote = torch.from_numpy(rng.random(N) < 0.5)
    keys = torch.from_numpy(np.sort(rng.choice(W * I, W * I // 8,
                                               replace=False))
                            .astype(np.int32))
    wps = W // owners
    rejects = 0
    for r in range(owners):
        w_lo = r * wps
        own = valid & (dst_w >= w_lo) & (dst_w < w_lo + wps)
        views = shard_view(got, r, wps), shard_view(want, r, wps)
        if drain == "tiered":
            _, rej = tt.apply_stock_updates_strict_tiered(
                views[0], keys, dst_w, i_id, qty, own, remote, I, w_lo=w_lo)
            assert int(rej) == int(_put_strict_tiered(
                views[1], keys, dst_w, i_id, qty, own, remote, I, w_lo))
            rejects += int(rej)
        else:
            restock = drain == "restock"
            tt.apply_stock_updates(views[0], dst_w - w_lo, i_id, qty, own,
                                   remote, restock=restock)
            _put_stock_updates(views[1], dst_w - w_lo, i_id, qty, own,
                               remote, restock)
    for name in STOCK:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int32), b.view(torch.int32)), name
    assert torch.equal(got.s_order_cnt, before.s_order_cnt) == (live == 0)
    if drain == "tiered":
        # cold cells that fit and cells that do not: both happened
        cold = valid & ~tt.hot_position(keys, dst_w * I + i_id)[1]
        assert 0 < rejects < int(cold.sum())


def test_escrow_share_and_hot_set_match_reference():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 50, 12).astype(np.int32)
    keys = np.sort(rng.choice(100, 12, replace=False)).astype(np.int32)
    for alive in (None, np.array([1, 0, 1], np.int32)):
        for r in range(3):
            want = jt.escrow_share_for(jnp.asarray(q), r, 3, alive=alive)
            got = tt.escrow_share_for(torch.from_numpy(q), r, 3, alive=alive)
            np.testing.assert_array_equal(_np(want), got.numpy())
            assert got.dtype == torch.int32
        j = JHotSetEscrow.make(3, keys, q, alive=alive)
        t = HotSetEscrow.make(3, torch.from_numpy(keys), torch.from_numpy(q),
                              alive=alive)
        assert _mismatches(j, t) == []
        np.testing.assert_array_equal(_np(j.remaining()),
                                      t.remaining().numpy())
    j = JHotSetEscrow.make(2, keys, q)
    t = escrow_from_numpy(jax.device_get(j), CPU)
    for key, amount in ((keys[3], 4), (keys[3], 1000), (7777, 1)):
        j, jok = j.try_spend(1, key, amount)
        t, tok = t.try_spend(1, torch.tensor(key), amount)
        assert bool(jok) == bool(tok)
    assert _mismatches(j, t) == []
    j2 = j.refresh(jnp.asarray(q // 2))
    t2 = t.refresh(torch.from_numpy(q // 2))
    assert _mismatches(j2, t2) == []
    assert _mismatches(JHotSetEscrow.join(j, j2), HotSetEscrow.join(t, t2)) \
        == []


def _drained_states():
    """A merge-regime state after a few batches (consistent), and a copy
    with one district counter broken (inconsistent), both sides."""
    scale = jt.TPCCScale(**SMALL)
    ref = jt.init_state(scale, seed=6)
    rng = np.random.default_rng(6)
    for i in range(12):
        ref, _, _ = jt.apply_neworder(ref, jt.generate_neworder(
            rng, scale, 16, ts0=16 * i), scale)
    ref = jax.device_get(ref)
    broken = ref._replace(d_next_o_id=np.asarray(ref.d_next_o_id) + np.eye(
        2, 2, dtype=np.int32))
    return [(ref, state_from_numpy(ref, CPU)),
            (broken, state_from_numpy(broken, CPU))]


def test_check_consistency_and_audit_verdicts_match_reference():
    q0 = np.asarray(jt.init_state(jt.TPCCScale(**SMALL), seed=6).s_quantity)
    verdicts = []
    for ref, port in _drained_states():
        want = jt.check_consistency(ref)
        assert tt.check_consistency(port) == want
        for kw in (dict(), dict(strict_stock=True, initial_stock=q0)):
            jrep = jaudit.audit_tpcc(ref, **kw)
            trep = taudit.audit_tpcc(port, **kw)
            assert trep.checks == jrep.checks and trep.ok == jrep.ok, kw
            verdicts.append(trep.ok)
    # restock breaks strict conservation; the broken counter breaks both
    assert verdicts == [True, False, False, False]


@pytest.mark.parametrize("stock_invariant", ["restock", "strict", "serial"])
def test_planner_copies_give_reference_verdicts(stock_invariant):
    want = jplan(jt.tpcc_state_specs(stock_invariant))
    got = plan(tt.tpcc_state_specs(stock_invariant))
    assert [(e.spec.name, e.coord_class.value, e.strategy.value,
             [(i, o, str(v)) for i, o, v in e.verdicts])
            for e in want.entries] == \
        [(e.spec.name, e.coord_class.value, e.strategy.value,
          [(i, o, str(v)) for i, o, v in e.verdicts])
         for e in got.entries]
    assert [(n, inv.name, inv.kind.value, c)
            for n, inv, c in jt.tpcc_invariants()] == \
        [(n, inv.name, inv.kind.value, c)
         for n, inv, c in tt.tpcc_invariants()]


def test_resolve_admission_and_cutover_memo():
    assert tt.resolve_admission("auto", tt.AUTO_KERNEL_MIN_BATCH - 1) == \
        jt.resolve_admission("auto", jt.AUTO_KERNEL_MIN_BATCH - 1)
    assert tt.resolve_admission("kernel", 1) == "kernel"
    with pytest.raises(ValueError, match="unknown admission"):
        tt.resolve_admission("warp", 8)
    with pytest.raises(ValueError, match="unknown effects"):
        tt.resolve_effects("warp")
    tt._CUTOVER_CACHE.clear()
    choice = tt.resolve_admission_cutover(8, 4, device=CPU, cells=64)
    assert choice in ("scan", "kernel")
    assert tt._CUTOVER_CACHE == {("cpu", 8, 4): choice}
    assert tt.resolve_admission("auto", 8, 4, CPU) == choice
