"""The port's coordinated baseline (``repro_torch.txn.twopc``) and the
plan-driven factory (``engine.plan_engine``) against the JAX package's, on
the CPU at the reference tests' small scale (``tests/test_engine.py``).

The strict and non-strict ``run_closed_loop_2pc`` end in the reference's
state with its committed and aborted counts; ``read_step`` returns the
reference's result; both strict engines (escrow and 2PC) hold the same
invariant on one stream, 2PC committing at least as much; the wall clock
charges ``commit_latency_s`` per conflicting round, as the reference
counts rounds. The port's strict step admits through ``ops.escrow_admit``
where the reference scans: the results are bit-identical.

Tolerance: exact (values and dtypes), as the reference's own 2PC tests
hold integer state; float32 totals and ``s_ytd`` sum in the same order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402

from repro.core.planner import CoordClass as JCoordClass  # noqa: E402
from repro.txn import tpcc as jt  # noqa: E402
from repro.txn import twopc as jtwopc  # noqa: E402
from repro.txn.engine import plan_engine as jplan_engine  # noqa: E402
from repro.txn.engine import single_host_engine as jengine  # noqa: E402
from repro_torch.convert import (batch_from_numpy,  # noqa: E402
                                 order_status_batch_from_numpy,
                                 state_to_numpy)
from repro_torch.core.planner import CoordClass  # noqa: E402
from repro_torch.txn import tpcc as tt  # noqa: E402
from repro_torch.txn import twopc  # noqa: E402
from repro_torch.txn.audit import assert_audit  # noqa: E402
from repro_torch.txn.drivers import run_loop  # noqa: E402
from repro_torch.txn.engine import Engine, plan_engine  # noqa: E402
from repro_torch.txn.twopc import TwoPCEngine, run_closed_loop_2pc  # noqa: E402

SMALL = dict(n_warehouses=4, districts=4, customers=8, n_items=64,
             order_capacity=128, max_lines=15)


def _mismatches(ref, port):
    """Fields whose dtype, shape or value differ (port side as numpy)."""
    ref = jax.device_get(ref)
    port = state_to_numpy(port)
    return [name for name, x, y in zip(ref._fields, ref, port)
            if np.asarray(x).dtype != y.dtype
            or np.asarray(x).shape != y.shape
            or not np.array_equal(np.asarray(x), y)]


def _engines(strict: bool):
    scale = jt.TPCCScale(**SMALL)
    mesh = jengine(scale).mesh
    return (jtwopc.TwoPCEngine(scale, mesh, ("data",), strict_stock=strict),
            TwoPCEngine(tt.TPCCScale(**SMALL), strict_stock=strict,
                        device="cpu"))


# (strict, run_closed_loop_2pc knobs): uniform and skewed items, remote lines
LOOPS = [(False, dict(remote_frac=0.3, seed=2)),
         (False, dict(item_skew=1.2, seed=4)),
         (True, dict(seed=2)),
         (True, dict(remote_frac=0.3, item_skew=1.2, seed=3))]


@pytest.mark.parametrize("strict,kw", LOOPS)
def test_closed_loop_2pc_matches_reference(strict, kw):
    je, te = _engines(strict)
    jstate = jt.init_state(je.scale)
    if strict:
        # scarce stock, so that the strict floor aborts transactions
        jstate = jstate._replace(s_quantity=jstate.s_quantity // 4)
    js, jst = jtwopc.run_closed_loop_2pc(
        je, jax.tree.map(lambda x: x.copy(), jstate), batch_per_shard=16,
        n_batches=5, **kw)
    ts = tt.init_state(te.scale, device="cpu")
    if strict:
        ts.s_quantity.floor_divide_(4)
    q0 = ts.s_quantity.clone()
    ts, tst = run_closed_loop_2pc(te, ts, batch_per_shard=16, n_batches=5,
                                  **kw)
    assert _mismatches(js, ts) == []
    assert (tst.committed, tst.aborted, tst.batches) == \
        (jst.committed, jst.aborted, jst.batches)
    if strict:
        assert 0 < tst.aborted < 80 and tst.batches == 5
        assert_audit(ts, initial_stock=q0, strict_stock=True)
    else:
        # the warm-up ran batch 0 on the state; batches 1..4 were timed
        assert tst.committed == 64 and tst.batches == 4
        assert int(ts.d_next_o_id.sum()) == 80


def test_nonstrict_2pc_equals_the_merge_regime():
    """On one shard every line is local, so the non-strict baseline's
    synchronous apply and the merge regime's deferred drain land the same
    effects: the whole state is equal (the reference's
    ``test_2pc_baseline_same_effects`` holds s_ytd and d_next_o_id)."""
    scale = tt.TPCCScale(**SMALL)
    merge = Engine(scale, device="cpu")
    s1, _, _ = run_loop(merge, tt.init_state(scale, device="cpu"),
                        batch_per_shard=8, n_batches=5, remote_frac=0.3,
                        merge_every=1, seed=2)
    s2, _ = run_closed_loop_2pc(TwoPCEngine(scale, device="cpu"),
                                tt.init_state(scale, device="cpu"),
                                batch_per_shard=8, n_batches=5,
                                remote_frac=0.3, seed=2)
    assert [f for f, x, y in zip(s1._fields, s1, s2)
            if not torch.equal(x, y)] == []


@pytest.mark.parametrize("strict", [False, True])
def test_read_step_matches_reference(strict):
    je, te = _engines(strict)
    js = jt.init_state(je.scale)
    ts = tt.init_state(te.scale, device="cpu")
    rng = np.random.default_rng(8)
    for i in range(3):
        jb = jt.generate_neworder(rng, je.scale, 16, ts0=16 * i)
        js = je.step(js, jb)[0]
        ts = te.step(ts, batch_from_numpy(jax.device_get(jb), "cpu"))[0]
    assert _mismatches(js, ts) == []
    jq = jt.generate_order_status(rng, je.scale, 32)
    # half the queries ask for a customer who has an order
    c = np.asarray(jq.c).copy()
    w, d = np.asarray(jq.w), np.asarray(jq.d)
    slot = (np.asarray(js.d_next_o_id)[w, d] - 1) % SMALL["order_capacity"]
    c[::2] = np.asarray(js.o_c_id)[w, d, slot][::2]
    jq = jq._replace(c=c)
    want = je.read_step(js, jq)
    got = te.read_step(ts, order_status_batch_from_numpy(
        jax.device_get(jq), "cpu"))
    assert _mismatches(want, got) == []
    assert int(got.found.sum()) >= 16


def test_plan_engine_three_choices():
    scale = tt.TPCCScale(**SMALL)
    free = plan_engine(scale, device="cpu")
    assert type(free) is Engine and free.stock_regime is CoordClass.FREE
    esc = plan_engine(scale, stock_invariant="strict", device="cpu",
                      escrow_layout="dense")
    assert type(esc) is Engine and esc.stock_regime is CoordClass.ESCROW
    assert esc.escrow_layout == "dense"
    two = plan_engine(scale, stock_invariant="serial", device="cpu")
    assert isinstance(two, TwoPCEngine) and two.strict_stock
    assert two.plan.entry("stock.s_quantity").coord_class \
        is CoordClass.REQUIRED
    # the reference makes the same three choices
    jscale = jt.TPCCScale(**SMALL)
    jtwo = jplan_engine(jscale, stock_invariant="serial")
    assert jtwo.plan.entry("stock.s_quantity").coord_class \
        is JCoordClass.REQUIRED and jtwo.strict_stock
    with pytest.raises(ValueError, match="plan_engine"):
        Engine(scale, stock_invariant="serial", device="cpu")
    # with two shards both 2PC paths carry collectives (the prepare
    # all-gather and the vote; the read's grant and release)
    two2 = plan_engine(scale, stock_invariant="serial", device="cpu",
                       n_shards=2)
    assert two2.n_shards == 2 and two2.w_per_shard == 2
    for method in (two2.hot_path_collectives, two2.read_path_collectives):
        stats = method(8)
        assert stats.total_ops > 0 and stats.counts["all-reduce"] >= 1
        assert "NONE" not in stats.describe()


def test_escrow_vs_2pc_same_strict_semantics():
    """Both strict engines hold the same invariant on the identical stream
    (no negative stock, exact conservation), and the global-pool 2PC
    baseline admits at least as much as share-partitioned escrow."""
    scale = tt.TPCCScale(**SMALL)
    eng = Engine(scale, stock_invariant="strict", device="cpu")
    two = plan_engine(scale, stock_invariant="serial", device="cpu")
    s1 = tt.init_state(scale, device="cpu")
    q0 = s1.s_quantity.clone()
    s1, esc, st1 = run_loop(eng, s1, batch_per_shard=8, n_batches=5,
                            merge_every=2, seed=2)
    s2, st2 = run_closed_loop_2pc(two, tt.init_state(scale, device="cpu"),
                                  batch_per_shard=8, n_batches=5, seed=2)
    assert_audit(s1, escrow=esc, initial_stock=q0, strict_stock=True)
    assert_audit(s2, initial_stock=q0, strict_stock=True)
    assert st2.committed >= st1.neworders
    assert st2.committed + st2.aborted == st1.neworders + st1.aborts == 40
    # on one shard the escrow's one replica holds the whole pool between
    # refreshes, so the two admit the same transactions: equal states
    assert st2.committed == st1.neworders
    assert [f for f, x, y in zip(s1._fields, s1, s2)
            if not torch.equal(x, y)] == []


def test_twopc_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scale = tt.TPCCScale(**SMALL)
    for make in (lambda **kw: TwoPCEngine(scale, **kw),
                 lambda **kw: plan_engine(scale, stock_invariant="serial",
                                          **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("strict", [False, True])
def test_latency_charge_is_rounds_times_commit_latency(strict):
    """``wall_seconds`` = device wall time + ``commit_latency_s`` x the
    rounds of every timed batch, rounds counted as the reference counts
    them (max transactions on one district)."""
    scale = tt.TPCCScale(**SMALL)
    kw = dict(batch_per_shard=16, n_batches=4, seed=11)
    rng = np.random.default_rng(kw["seed"])
    rounds = []
    for i in range(kw["n_batches"]):
        jb = jt.generate_neworder(rng, jt.TPCCScale(**SMALL), 16, ts0=16 * i)
        want = jtwopc._conflict_rounds(jb, scale.districts)
        got = twopc._conflict_rounds(batch_from_numpy(jax.device_get(jb),
                                                      "cpu"), scale.districts)
        assert got == want and got >= 2
        rounds.append(got)
    timed = rounds if strict else rounds[1:]
    latency = 1000.0   # s: far above the run's own wall time
    two = TwoPCEngine(scale, strict_stock=strict, device="cpu")
    _, free = run_closed_loop_2pc(two, tt.init_state(scale, device="cpu"),
                                  **kw)
    _, charged = run_closed_loop_2pc(two, tt.init_state(scale, device="cpu"),
                                     commit_latency_s=latency, **kw)
    charge = latency * sum(timed)
    assert charge <= charged.wall_seconds < charge + 60.0
    assert free.wall_seconds < 60.0
    assert charged.committed == free.committed
