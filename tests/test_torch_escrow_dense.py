"""The port's dense escrow layout against the JAX package's, on the CPU.

The dense layout is the ``[R, W, I]`` ``EscrowCounter``: every replica a
share of every (warehouse, item) cell. Held against the reference on the
reference tests' small scale (``tests/test_engine.py``), inputs from shared
seeds: ``make_escrow_shares``, ``apply_neworder_escrow`` over every
``admission`` x ``effects`` of the port (the oracle is the reference's
definitional ``admission="scan", effects="scan"``), the dense ``run_loop``
against the reference's ``run_escrow_loop(..., fused=False)``; inside the
port, the sparse layout with a full hot set against the dense one; and the
audit's dense branch.

Tolerance: exact (values and dtypes). The float32 totals and ``s_ytd`` are
exact because both packages sum in the same order (integer addends below
2**24 for ``s_ytd``, an order's lines in line order for the totals).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402

from repro.txn import tpcc as jt  # noqa: E402
from repro.txn.audit import assert_audit as jassert_audit  # noqa: E402
from repro.txn.drivers import run_escrow_loop as jrun_escrow  # noqa: E402
from repro.txn.engine import single_host_engine as jengine  # noqa: E402
from repro_torch.convert import state_to_numpy  # noqa: E402
from repro_torch.core.lattice import EscrowCounter  # noqa: E402
from repro_torch.txn import tpcc as tt  # noqa: E402
from repro_torch.txn.audit import assert_audit, audit_tpcc  # noqa: E402
from repro_torch.txn.drivers import run_loop  # noqa: E402
from repro_torch.txn.engine import single_host_engine  # noqa: E402

SMALL = dict(n_warehouses=4, districts=4, customers=8, n_items=64,
             order_capacity=128, max_lines=15)
COUNTS = ("neworders", "aborts", "cold_rejects", "refreshes",
          "anti_entropy_rounds", "payments", "order_statuses",
          "stock_levels", "deliveries", "reads_found", "fractures_observed",
          "lines_repaired")


def _mismatches(ref, port):
    """Fields whose dtype, shape or value differ (port side as numpy)."""
    ref = jax.device_get(ref)
    port = state_to_numpy(port)
    return [name for name, x, y in zip(ref._fields, ref, port)
            if np.asarray(x).dtype != y.dtype
            or np.asarray(x).shape != y.shape
            or not np.array_equal(np.asarray(x), y)]


def _counts(stats):
    return tuple(getattr(stats, k) for k in COUNTS)


@pytest.mark.parametrize("replicas", [1, 3])
def test_make_escrow_shares_matches_reference(replicas):
    q = np.random.default_rng(replicas).integers(
        0, 200, (4, 64)).astype(np.int32)
    want = np.asarray(jt.make_escrow_shares(q, replicas))
    got = tt.make_escrow_shares(torch.from_numpy(q), replicas)
    assert got.dtype == torch.int32 and got.shape == (replicas, 4, 64)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got.sum(0), torch.from_numpy(q))


# (w_lo, w_hi, replica, num_replicas): the whole store as one shard, and
# warehouses [2, 4) as replica 1 of 3 (its lines to warehouses 0-1 remote)
SHARDS = {"one_shard": (0, 4, 0, 1), "replica_1_of_3": (2, 4, 1, 3)}


@pytest.mark.parametrize("effects", ["scan", "fused"])
@pytest.mark.parametrize("admission", ["scan", "kernel"])
@pytest.mark.parametrize("shard", list(SHARDS))
def test_apply_neworder_escrow_matches_reference(shard, admission, effects):
    w_lo, w_hi, replica, R = SHARDS[shard]
    scale = jt.TPCCScale(**SMALL)
    full = jt.init_state(scale, seed=1)
    shares = np.array(jt.make_escrow_shares(
        np.asarray(full.s_quantity), R))[replica]
    spent = np.random.default_rng(4).integers(
        0, 3, shares.shape).astype(np.int32)
    spent = np.minimum(spent, shares)
    js = jax.tree.map(lambda x: x[w_lo:w_hi], full)
    batch = dict(batch=48, remote_frac=0.3, w_lo=w_lo, w_hi=w_hi, ts0=7,
                 item_skew=1.2)
    jb = jt.generate_neworder(np.random.default_rng(5), scale, **batch)
    want = jt.apply_neworder_escrow(
        js, shares, spent, jb, scale, w_lo=w_lo, w_hi=w_hi,
        replica=replica, num_replicas=R, admission="scan", effects="scan")

    ts = tt.TPCCState(*(x[w_lo:w_hi].contiguous() for x in tt.init_state(
        tt.TPCCScale(**SMALL), seed=1, device="cpu")))
    tb = tt.generate_neworder(np.random.default_rng(5), tt.TPCCScale(**SMALL),
                              device="cpu", **batch)
    got = tt.apply_neworder_escrow(
        ts, torch.from_numpy(shares), torch.from_numpy(spent), tb,
        tt.TPCCScale(**SMALL), w_lo=w_lo, w_hi=w_hi, replica=replica,
        num_replicas=R, admission=admission, effects=effects)

    assert _mismatches(want[0], got[0]) == []          # state
    assert _mismatches(want[2], got[2]) == []          # outbox
    for name, x, y in (("spent", want[1], got[1]), ("total", want[3], got[3]),
                       ("committed", want[4], got[4])):
        x = np.asarray(x)
        assert x.dtype == y.numpy().dtype and np.array_equal(x, y.numpy()), \
            name
    committed = got[4]
    # contended: some transactions abort, some commit; some lines remote
    assert 0 < int(committed.sum()) < committed.numel()
    if w_hi - w_lo < 4:
        assert bool(got[2].valid.any())


# (admission, effects, mix): the run_escrow_loop knobs on both sides
LOOPS = [("kernel", "fused", True), ("kernel", "scan", True),
         ("scan", "scan", False), ("kernel", "fused", False)]


@pytest.mark.parametrize("admission,effects,mix", LOOPS)
def test_dense_run_loop_matches_reference(admission, effects, mix):
    """The dense closed loop (New-Order alone or the five-transaction mix)
    against ``run_escrow_loop(..., fused=False)``: final state, final
    EscrowCounter, the MixStats counts and the audit's checks."""
    kw = dict(batch_per_shard=16, n_batches=6, remote_frac=0.3,
              merge_every=2, refresh_every=2, seed=6, item_skew=1.2)
    ekw = dict(stock_invariant="strict", escrow_layout="dense",
               admission=admission, effects=effects)
    scale = jt.TPCCScale(**SMALL)
    je = jengine(scale, **ekw)
    j0 = je.shard_state(jt.init_state(scale))
    jq0 = j0.s_quantity.copy()
    js, jesc, jm = jrun_escrow(je, j0, fused=False, mix=mix, **kw)

    te = single_host_engine(tt.TPCCScale(**SMALL), device="cpu", **ekw)
    t0 = tt.init_state(te.scale, device="cpu")
    q0 = t0.s_quantity.clone()
    ts, tesc, tm = run_loop(te, t0, payments=mix, reads=mix, deliveries=mix,
                            **kw)
    assert isinstance(tesc, EscrowCounter) and tesc.shares.shape == (1, 4, 64)
    assert _mismatches(js, ts) == []
    assert _mismatches(jesc, tesc) == []
    assert _counts(jm) == _counts(tm)
    assert tm.aborts > 0 and tm.neworders > 0 and tm.cold_rejects == 0
    jrep = jassert_audit(js, escrow=jesc, initial_stock=jq0,
                         strict_stock=True)
    rep = assert_audit(ts, escrow=tesc, initial_stock=q0, strict_stock=True)
    assert rep.checks == jrep.checks and "escrow_covers_stock" in rep.checks
    assert te.escrow_bytes_per_device() == je.escrow_bytes_per_device()


def test_engine_dense_steps_match_reference():
    """init_escrow / neworder_escrow_step / drain_strict / refresh_escrow
    (with the one replica slot masked dead, then live) of the dense
    layout, one call at a time."""
    scale = jt.TPCCScale(**SMALL)
    ekw = dict(stock_invariant="strict", escrow_layout="dense",
               admission="kernel", effects="fused")
    je = jengine(scale, **ekw)
    te = single_host_engine(tt.TPCCScale(**SMALL), device="cpu", **ekw)
    js = je.shard_state(jt.init_state(scale))
    ts = tt.init_state(te.scale, device="cpu")
    jesc, tesc = je.init_escrow(js), te.init_escrow(ts)
    assert _mismatches(jesc, tesc) == []
    batch = dict(batch=32, remote_frac=0.5, item_skew=1.0)
    jb = jt.generate_neworder(np.random.default_rng(2), scale, **batch)
    tb = tt.generate_neworder(np.random.default_rng(2), te.scale,
                              device="cpu", **batch)
    js, jesc, jd, _, _ = je.neworder_escrow_step(js, jesc, jb)
    ts, tesc, td, _, _ = te.neworder_escrow_step(ts, tesc, tb)
    assert _mismatches(jesc, tesc) == [] and _mismatches(jd, td) == []
    js, jrej = je.drain_strict(js, jd)
    ts, trej = te.drain_strict(ts, td)
    assert np.array_equal(np.asarray(jrej), trej.numpy())
    assert trej.tolist() == [0]
    for alive in (np.array([0], np.int32), None):
        # the reference donates the escrow it refreshes
        jcopy = jax.tree.map(lambda x: x.copy(), jesc)
        assert _mismatches(je.refresh_escrow(js, jcopy, alive),
                           te.refresh_escrow(ts, tesc, alive)) == []
    assert _mismatches(js, ts) == []


def test_sparse_with_full_hot_set_equals_dense():
    """``hot_items = n_items`` makes the hot set the whole keyspace: the
    two-tier layout's admission is then the dense counter's, and the final
    state, the counts and the spent table (re-indexed) must be equal."""
    kw = dict(batch_per_shard=8, n_batches=6, remote_frac=0.2,
              merge_every=2, refresh_every=2, seed=5, item_skew=1.2)
    scale = tt.TPCCScale(**SMALL)
    runs = []
    for ekw in (dict(escrow_layout="sparse", hot_items=scale.n_items),
                dict(escrow_layout="dense")):
        eng = single_host_engine(scale, stock_invariant="strict",
                                 admission="kernel", effects="fused",
                                 device="cpu", **ekw)
        runs.append(run_loop(eng, tt.init_state(scale, device="cpu"), **kw))
    (s1, e1, m1), (s2, e2, m2) = runs
    assert [f for f, x, y in zip(s1._fields, s1, s2)
            if not torch.equal(x, y)] == []
    assert (m1.neworders, m1.aborts) == (m2.neworders, m2.aborts)
    assert m1.aborts > 0 and m1.cold_rejects == m2.cold_rejects == 0
    assert torch.equal(e1.spent.reshape(-1), e2.spent.reshape(-1))
    assert torch.equal(e1.shares.reshape(-1), e2.shares.reshape(-1))


def test_dense_audit_catches_a_planted_mismatch():
    scale = tt.TPCCScale(**SMALL)
    eng = single_host_engine(scale, stock_invariant="strict",
                             escrow_layout="dense", device="cpu")
    state = tt.init_state(scale, device="cpu")
    q0 = state.s_quantity.clone()
    state, esc, _ = run_loop(eng, state, batch_per_shard=8, n_batches=4,
                             merge_every=2, seed=0, item_skew=1.2)
    kw = dict(initial_stock=q0, strict_stock=True)
    rep = audit_tpcc(state, escrow=esc, **kw)
    assert rep.ok and "escrow_covers_stock" in rep.checks
    assert "escrow_covers_hot_stock" not in rep.checks
    # one unit spent that the stock never lost
    spent = esc.spent.clone()
    spent[0, 1, 3] += 1
    bad = audit_tpcc(state, escrow=esc._replace(spent=spent), **kw)
    assert bad.failures == ["escrow_covers_stock"]
    # a share the stock does not hold, driving the remaining negative
    shares = esc.shares.clone()
    shares[0, 2, 5] = -1 - int(esc.spent[0, 2, 5])
    bad = audit_tpcc(state, escrow=esc._replace(shares=shares), **kw)
    assert set(bad.failures) == {"escrow_covers_stock",
                                 "escrow_remaining_nonnegative"}
