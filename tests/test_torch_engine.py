"""The port as a whole: its closed loop against the JAX package's.

The port's ``single_host_engine(..., device="cpu")`` and the reference's
``single_host_engine`` each run ``run_loop`` on the per-batch dispatch path
(``fused=False``) with the same seed at small scale, in the merge regime
and in the escrow regime (sparse hot set, Zipfian items, inflated stock so
that some batches carry residual, contended transactions and some abort)
over every ``admission`` x ``effects`` combination, New-Order alone and in
the five-transaction mix (Payment, Order-Status, Stock-Level, Delivery).
Final state, final escrow and the MixStats counts must be equal; both
sides audit clean.

Tolerance: exact, values and dtypes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402

from repro.txn import tpcc as jt  # noqa: E402
from repro.txn.drivers import run_loop as jrun_loop  # noqa: E402
from repro.txn.engine import single_host_engine as jengine  # noqa: E402
from repro_torch.convert import (batch_from_numpy,  # noqa: E402
                                 order_status_batch_from_numpy,
                                 payment_batch_from_numpy, state_to_numpy,
                                 stock_level_batch_from_numpy)
from repro_torch.txn import tpcc as tt  # noqa: E402
from repro_torch.txn.drivers import run_loop  # noqa: E402
from repro_torch.txn.engine import single_host_engine  # noqa: E402

SMALL = dict(n_warehouses=2, districts=2, customers=8, n_items=64,
             order_capacity=256, max_lines=15)
COUNTS = ("neworders", "aborts", "cold_rejects", "refreshes",
          "anti_entropy_rounds")
MIX_COUNTS = COUNTS + ("payments", "order_statuses", "stock_levels",
                       "deliveries", "reads_found", "fractures_observed",
                       "lines_repaired")


def _mismatches(ref, port):
    ref = jax.device_get(ref)
    port = state_to_numpy(port)
    return [name for name, x, y in zip(ref._fields, ref, port)
            if np.asarray(x).dtype != y.dtype
            or not np.array_equal(np.asarray(x), y)]


def _counts(stats):
    return tuple(getattr(stats, k) for k in COUNTS)


def test_merge_regime_closed_loop_matches_reference():
    kw = dict(batch_per_shard=16, n_batches=6, remote_frac=0.3,
              merge_every=2, seed=4, audit=True)
    scale = jt.TPCCScale(**SMALL)
    je = jengine(scale)
    js, _, jm = jrun_loop(je, je.shard_state(jt.init_state(scale)),
                          fused=False, **kw)
    te = single_host_engine(tt.TPCCScale(**SMALL), device="cpu")
    ts, tesc, tm = run_loop(te, tt.init_state(te.scale, device="cpu"), **kw)
    assert tesc is None
    assert _mismatches(js, ts) == []
    assert _counts(jm) == _counts(tm)
    assert tm.neworders == 96 and tm.anti_entropy_rounds == 3


@pytest.mark.parametrize("effects", ["scan", "fused"])
@pytest.mark.parametrize("admission", ["scan", "kernel"])
def test_escrow_regime_closed_loop_matches_reference(admission, effects):
    kw = dict(batch_per_shard=16, n_batches=6, remote_frac=0.3,
              merge_every=2, refresh_every=2, seed=5, item_skew=1.2,
              audit=True)
    scale = jt.TPCCScale(**SMALL)
    je = jengine(scale, stock_invariant="strict", hot_items=4,
                 admission=admission, effects=effects)
    j0 = jt.init_state(scale)
    j0 = j0._replace(s_quantity=j0.s_quantity * 3)
    js, jesc, jm = jrun_loop(je, je.shard_state(j0), fused=False, **kw)

    te = single_host_engine(tt.TPCCScale(**SMALL), stock_invariant="strict",
                            hot_items=4, admission=admission,
                            effects=effects, device="cpu")
    t0 = tt.init_state(te.scale, device="cpu")
    t0.s_quantity.mul_(3)
    ts, tesc, tm = run_loop(te, t0, **kw)
    assert _mismatches(js, ts) == []
    assert _mismatches(jesc, tesc) == []
    assert _counts(jm) == _counts(tm)
    # contended batches with residual work and aborts, and commits too
    assert tm.aborts > 0 and tm.neworders > 0


MIXES = {
    "full": dict(payments=True, reads=True, deliveries=True),
    # reads draw the mix's Payment batches even with Payment off: the
    # New-Order stream must be the reference's all the same
    "reads_without_payments": dict(payments=False, reads=True,
                                   deliveries=False),
    "payments_and_deliveries": dict(payments=True, reads=False,
                                    deliveries=True),
}
# (regime, effects, mix); effects changes nothing in the merge regime
MIX_CASES = [("merge", "fused", "full"), ("escrow", "scan", "full"),
             ("escrow", "fused", "full"),
             ("merge", "scan", "reads_without_payments"),
             ("escrow", "fused", "reads_without_payments"),
             ("merge", "scan", "payments_and_deliveries")]


@pytest.mark.parametrize("regime,effects,mix", MIX_CASES)
def test_mix_closed_loop_matches_reference(regime, effects, mix):
    """``run_loop`` with the mix knobs against the reference's dispatch
    path."""
    kw = dict(batch_per_shard=16, n_batches=6, remote_frac=0.3,
              merge_every=2, seed=4, audit=True, read_frac=0.5,
              **MIXES[mix])
    ekw = dict(effects=effects)
    if regime == "escrow":
        kw.update(refresh_every=2, item_skew=1.2)
        ekw.update(stock_invariant="strict", hot_items=4, admission="kernel")
    scale = jt.TPCCScale(**SMALL)
    je = jengine(scale, **ekw)
    j0 = jt.init_state(scale)
    j0 = j0._replace(s_quantity=j0.s_quantity * 3)
    js, jesc, jm = jrun_loop(je, je.shard_state(j0), fused=False, **kw)

    te = single_host_engine(tt.TPCCScale(**SMALL), device="cpu", **ekw)
    t0 = tt.init_state(te.scale, device="cpu")
    t0.s_quantity.mul_(3)
    ts, tesc, tm = run_loop(te, t0, **kw)
    assert _mismatches(js, ts) == []
    if regime == "escrow":
        assert _mismatches(jesc, tesc) == []
        assert tm.aborts > 0
    assert tuple(getattr(jm, k) for k in MIX_COUNTS) == \
        tuple(getattr(tm, k) for k in MIX_COUNTS)
    assert tm.neworders > 0 and tm.fractures_observed == 0
    if MIXES[mix]["payments"]:
        assert tm.payments == 96 and float(ts.w_ytd.sum()) > 0
    if MIXES[mix]["reads"]:
        assert tm.order_statuses == tm.stock_levels == 48
        assert tm.reads_found > 0
    if MIXES[mix]["deliveries"]:
        assert tm.deliveries > 0 and float(ts.c_delivered_sum.sum()) > 0


def test_engine_mix_steps_match_reference():
    """payment_step / order_status_step / stock_level_step / delivery_step
    one call at a time, after a few New-Orders."""
    scale = jt.TPCCScale(**SMALL)
    je = jengine(scale)
    te = single_host_engine(tt.TPCCScale(**SMALL), device="cpu")
    js = je.shard_state(jt.init_state(scale))
    ts = tt.init_state(te.scale, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(3):
        jb = jt.generate_neworder(rng, scale, 16, ts0=16 * i)
        js = je.neworder_step(js, jb)[0]
        ts = te.neworder_step(ts, batch_from_numpy(jax.device_get(jb),
                                                   "cpu"))[0]
    assert _mismatches(js, ts) == []
    pb = jt.generate_payment(rng, scale, 16)
    js = je.payment_step(js, pb)
    ts = te.payment_step(ts, payment_batch_from_numpy(jax.device_get(pb),
                                                      "cpu"))
    ob = jt.generate_order_status(rng, scale, 8)
    sb = jt.generate_stock_level(rng, scale, 8)
    assert _mismatches(je.order_status_step(js, ob), te.order_status_step(
        ts, order_status_batch_from_numpy(jax.device_get(ob), "cpu"))) == []
    assert _mismatches(je.stock_level_step(js, sb), te.stock_level_step(
        ts, stock_level_batch_from_numpy(jax.device_get(sb), "cpu"))) == []
    js, jn = je.delivery_step(js)
    ts, tn = te.delivery_step(ts)
    assert np.array_equal(np.asarray(jn), tn.numpy()) and int(tn[0]) == 4
    assert _mismatches(js, ts) == []


def test_escrow_adaptive_refresh_matches_reference():
    """The abort-rate refresh controller decides identically."""
    kw = dict(batch_per_shard=16, n_batches=8, remote_frac=0.2,
              merge_every=2, refresh_abort_rate=0.3, seed=9, item_skew=1.2)
    scale = jt.TPCCScale(**SMALL)
    je = jengine(scale, stock_invariant="strict", hot_items=4,
                 admission="kernel", effects="fused")
    j0 = jt.init_state(scale)
    j0 = j0._replace(s_quantity=j0.s_quantity * 4)
    js, jesc, jm = jrun_loop(je, je.shard_state(j0), fused=False, **kw)
    te = single_host_engine(tt.TPCCScale(**SMALL), stock_invariant="strict",
                            hot_items=4, admission="kernel", effects="fused",
                            device="cpu")
    t0 = tt.init_state(te.scale, device="cpu")
    t0.s_quantity.mul_(4)
    ts, tesc, tm = run_loop(te, t0, **kw)
    assert _mismatches(js, ts) == [] and _mismatches(jesc, tesc) == []
    assert _counts(jm) == _counts(tm)
    assert 0 < tm.refreshes < tm.anti_entropy_rounds


def test_engine_escrow_steps_match_reference():
    """init_escrow / neworder_escrow_step / drain_strict / refresh_escrow
    (with a dead replica slot masked in) one call at a time."""
    scale = jt.TPCCScale(**SMALL)
    je = jengine(scale, stock_invariant="strict", hot_items=4,
                 admission="scan", effects="scan")
    te = single_host_engine(tt.TPCCScale(**SMALL), stock_invariant="strict",
                            hot_items=4, admission="scan", effects="scan",
                            device="cpu")
    js = je.shard_state(jt.init_state(scale))
    ts = tt.init_state(te.scale, device="cpu")
    jesc, tesc = je.init_escrow(js), te.init_escrow(ts)
    assert _mismatches(jesc, tesc) == []
    batch = dict(batch=16, remote_frac=0.5, item_skew=1.0)
    jb = jt.generate_neworder(np.random.default_rng(2), scale, **batch)
    tb = tt.generate_neworder(np.random.default_rng(2), te.scale,
                              device="cpu", **batch)
    js, jesc, jd, _, _ = je.neworder_escrow_step(js, jesc, jb)
    ts, tesc, td, _, _ = te.neworder_escrow_step(ts, tesc, tb)
    js, jrej = je.drain_strict(js, jd)
    ts, trej = te.drain_strict(ts, td)
    assert np.array_equal(np.asarray(jrej), trej.numpy())
    for alive in (None, np.array([0], np.int32)):
        # the reference donates the escrow it refreshes
        jcopy = jax.tree.map(lambda x: x.copy(), jesc)
        assert _mismatches(je.refresh_escrow(js, jcopy, alive),
                           te.refresh_escrow(ts, tesc, alive)) == []
    assert _mismatches(js, ts) == []
    assert te.escrow_bytes_per_device() == je.escrow_bytes_per_device()
