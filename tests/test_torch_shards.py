"""Multi-shard TPC-C on one card against the JAX package's sharded runs.

The port holds R shards as contiguous row blocks of the global tables on
one device (``Engine(n_shards=R)``, ``TwoPCEngine(n_shards=R)``); the
reference runs R simulated CPU devices under ``shard_map``. One
module-scoped fixture runs the reference once, in a subprocess with
``--xla_force_host_platform_device_count=4`` (meshes of 2 and 4 devices),
and hands every result over as an ``.npz``. Each test, for R in {2, 4},
runs the same seeded stream through the port on the CPU:

* the merge ``run_loop``, New-Order alone and with the mix;
* sparse and dense escrow, every ``admission`` x ``effects``, audited;
* a share refresh with one replica dead, then a batch and a drain;
* ``run_loop`` with the adaptive refresh (``refresh_abort_rate``) and
  with a dead replica (``alive``), in both layouts;
* ``TwoPCEngine``, strict and not, and ``read_step``.

Tolerance: exact, values and dtypes. Integer and bool tensors are equal;
so are floats: the integer-valued adds (``s_ytd``, stock) are exact in
any order below 2**24, and the others (Payment's amounts, New-Order's
totals, balances) add on each shard in the reference's order.

The structural proofs run on the port alone: the hot paths and the RAMP
reads call no collective and leave foreign slices untouched; anti-entropy,
the refresh and both 2PC paths call collectives.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side, in a subprocess

from repro_torch.convert import state_to_numpy  # noqa: E402
from repro_torch.txn import collectives  # noqa: E402
from repro_torch.txn import tpcc as tt  # noqa: E402
from repro_torch.txn.drivers import run_loop  # noqa: E402
from repro_torch.txn.engine import Engine  # noqa: E402
from repro_torch.txn.twopc import (TwoPCEngine,  # noqa: E402
                                   run_closed_loop_2pc)

ROOT = Path(__file__).resolve().parents[1]
SCALE = tt.TPCCScale(n_warehouses=8, districts=4, customers=8, n_items=64,
                     order_capacity=64, max_lines=15)
MERGE = dict(batch_per_shard=8, n_batches=6, remote_frac=0.3, merge_every=2,
             seed=4)
MIX = dict(payments=True, reads=True, deliveries=True)
ESCROW = dict(batch_per_shard=8, n_batches=6, remote_frac=0.5, merge_every=2,
              refresh_every=2, seed=5, item_skew=1.2)
TWOPC = dict(batch_per_shard=8, n_batches=5, remote_frac=0.3, seed=2,
             item_skew=1.2)
# run_loop's per-replica knobs: the adaptive refresh (at a rate, a number
# of shards each, that refreshes at some windows and not at others), and
# replica 1 dead
KNOBS = dict(adaptive=dict(refresh_abort_rate={2: 0.4, 4: 0.6}, n_batches=8),
             dead=dict(alive=1))
COUNTS = ("neworders", "aborts", "cold_rejects", "refreshes",
          "anti_entropy_rounds", "payments", "order_statuses",
          "stock_levels", "deliveries", "reads_found", "fractures_observed",
          "lines_repaired")
SHARDS = [2, 4]

_REFERENCE = r"""
import sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.txn import tpcc
from repro.txn.drivers import _home_partitioned, _neworder_batch, run_loop
from repro.txn.engine import Engine
from repro.txn.twopc import TwoPCEngine, run_closed_loop_2pc

assert len(jax.devices()) == 4, jax.devices()
scale = tpcc.TPCCScale(n_warehouses=8, districts=4, customers=8, n_items=64,
                       order_capacity=64, max_lines=15)
MERGE = dict(batch_per_shard=8, n_batches=6, remote_frac=0.3, merge_every=2,
             seed=4)
MIX = dict(payments=True, reads=True, deliveries=True)
ESCROW = dict(batch_per_shard=8, n_batches=6, remote_frac=0.5, merge_every=2,
              refresh_every=2, seed=5, item_skew=1.2)
TWOPC = dict(batch_per_shard=8, n_batches=5, remote_frac=0.3, seed=2,
             item_skew=1.2)
# run_loop's per-replica knobs: the adaptive refresh (at a rate, a number
# of shards each, that refreshes at some windows and not at others), and
# replica 1 dead
KNOBS = dict(adaptive=dict(refresh_abort_rate={2: 0.4, 4: 0.6}, n_batches=8),
             dead=dict(alive=1))
COUNTS = ("neworders", "aborts", "cold_rejects", "refreshes",
          "anti_entropy_rounds", "payments", "order_statuses",
          "stock_levels", "deliveries", "reads_found", "fractures_observed",
          "lines_repaired")
out = {}


def put(tag, tree):
    for f, x in zip(tree._fields, jax.device_get(tree)):
        out[f"{tag}/{f}"] = np.asarray(x)


for R in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
    e = Engine(scale, mesh)
    for mix in (False, True):
        s, _, st = run_loop(e, e.shard_state(tpcc.init_state(scale)),
                            fused=False, **MERGE, **(MIX if mix else {}))
        put(f"R{R}/merge{int(mix)}", s)
        out[f"R{R}/merge{int(mix)}/counts"] = np.array(
            [getattr(st, k) for k in COUNTS])
        if mix:
            rng = np.random.default_rng(9)
            osb = _home_partitioned(tpcc.generate_order_status, rng, e, 8)
            put(f"R{R}/os_batch", osb)
            put(f"R{R}/os", e.order_status_step(s, osb))
            put(f"R{R}/read_step",
                TwoPCEngine(scale, mesh).read_step(s, osb))
    for layout in ("sparse", "dense"):
        e = Engine(scale, mesh, stock_invariant="strict",
                   escrow_layout=layout, hot_items=4, admission="scan",
                   effects="scan")
        s0 = tpcc.init_state(scale)
        s0 = s0._replace(s_quantity=s0.s_quantity * 3)
        s, esc, st = run_loop(e, e.shard_state(s0), fused=False, **ESCROW)
        tag = f"R{R}/{layout}"
        put(tag, s)
        put(f"{tag}/esc", esc)
        out[f"{tag}/counts"] = np.array([getattr(st, k) for k in COUNTS])
        # one replica dies: refresh without it, then a batch and a drain
        alive = np.ones(R, np.int32)
        alive[1] = 0
        esc = e.refresh_escrow(s, esc, alive)
        put(f"{tag}/alive_esc", esc)
        b, _ = _neworder_batch(e, np.random.default_rng(7), 8, 0.3, 10_000,
                               1.2)
        s, esc, delta, total, ok = e.neworder_escrow_step(s, esc, b)
        s, rej = e.drain_strict(s, delta)
        put(f"{tag}/alive", s)
        put(f"{tag}/alive_esc2", esc)
        out[f"{tag}/alive_ok"] = np.asarray(ok)
        out[f"{tag}/alive_total"] = np.asarray(total)
        out[f"{tag}/alive_rej"] = np.asarray(rej)
        for knob, over in KNOBS.items():
            over = dict(over)
            if "alive" in over:
                over["alive"] = alive
            else:
                over["refresh_abort_rate"] = over["refresh_abort_rate"][R]
            s0 = tpcc.init_state(scale)
            s0 = s0._replace(s_quantity=s0.s_quantity * 3)
            s, esc, st = run_loop(e, e.shard_state(s0), fused=False,
                                  **dict(ESCROW, **over))
            put(f"{tag}/{knob}", s)
            put(f"{tag}/{knob}/esc", esc)
            out[f"{tag}/{knob}/counts"] = np.array(
                [getattr(st, k) for k in COUNTS])
    for strict in (False, True):
        t = TwoPCEngine(scale, mesh, strict_stock=strict)
        s, st = run_closed_loop_2pc(t, e.shard_state(tpcc.init_state(scale)),
                                    **TWOPC)
        put(f"R{R}/2pc{int(strict)}", s)
        out[f"R{R}/2pc{int(strict)}/counts"] = np.array(
            [st.committed, st.aborted, st.batches])
np.savez(sys.argv[1], **out)
print("OK", len(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results on meshes of 2 and 4 simulated devices."""
    path = tmp_path_factory.mktemp("shards") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as data:
        return dict(data)


def _mismatches(ref, tag, port):
    """Fields of ``port`` whose dtype, shape or value differ from the
    reference's under ``tag``."""
    port = state_to_numpy(port)
    return [f for f, y in zip(port._fields, port)
            if ref[f"{tag}/{f}"].dtype != y.dtype
            or ref[f"{tag}/{f}"].shape != y.shape
            or not np.array_equal(ref[f"{tag}/{f}"], y)]


def _counts(st):
    return [getattr(st, k) for k in COUNTS]


def _escrow_engine(R, layout, admission="scan", effects="scan"):
    return Engine(SCALE, stock_invariant="strict", escrow_layout=layout,
                  hot_items=4, admission=admission, effects=effects,
                  device="cpu", n_shards=R)


def _escrow_run(e):
    s0 = tt.init_state(SCALE, device="cpu")
    s0.s_quantity.mul_(3)
    return run_loop(e, s0, audit=True, **ESCROW)


@pytest.mark.parametrize("mix", [False, True], ids=["neworder", "mix"])
@pytest.mark.parametrize("R", SHARDS)
def test_merge_run_loop_matches_reference(ref, R, mix):
    e = Engine(SCALE, device="cpu", n_shards=R)
    s, esc, st = run_loop(e, tt.init_state(SCALE, device="cpu"), audit=True,
                          **MERGE, **(MIX if mix else {}))
    tag = f"R{R}/merge{int(mix)}"
    assert esc is None and _mismatches(ref, tag, s) == []
    assert _counts(st) == ref[f"{tag}/counts"].tolist()
    assert st.neworders == 8 * R * 6 and st.fractures_observed == 0


@pytest.mark.parametrize("effects", ["scan", "fused"])
@pytest.mark.parametrize("admission", ["scan", "kernel"])
@pytest.mark.parametrize("layout", ["sparse", "dense"])
@pytest.mark.parametrize("R", SHARDS)
def test_escrow_run_loop_matches_reference(ref, R, layout, admission,
                                           effects):
    """Replica r admits against its own ``1/R`` share; the strict audit
    sums the shares over replicas against the stock."""
    e = _escrow_engine(R, layout, admission, effects)
    s, esc, st = _escrow_run(e)
    tag = f"R{R}/{layout}"
    assert _mismatches(ref, tag, s) == []
    assert _mismatches(ref, f"{tag}/esc", esc) == []
    assert esc.shares.shape[0] == R
    assert _counts(st) == ref[f"{tag}/counts"].tolist()
    assert st.neworders > 0 and st.aborts > 0 and st.refreshes > 0


@pytest.mark.parametrize("layout", ["sparse", "dense"])
@pytest.mark.parametrize("R", SHARDS)
def test_refresh_with_a_dead_replica_matches_reference(ref, R, layout):
    """Replica 1 dies: the refresh gives it nothing and its headroom to
    the survivors, so its next batch aborts whole."""
    e = _escrow_engine(R, layout)
    s, esc, _ = _escrow_run(e)
    alive = np.ones(R, np.int32)
    alive[1] = 0
    tag = f"R{R}/{layout}"
    esc = e.refresh_escrow(s, esc, torch.from_numpy(alive))
    assert _mismatches(ref, f"{tag}/alive_esc", esc) == []
    assert int(esc.shares[1].sum()) == 0
    b, _ = tt.neworder_batch(e, np.random.default_rng(7), 8, 0.3, 10_000,
                             1.2)
    s, esc, delta, total, ok = e.neworder_escrow_step(s, esc, b)
    s, rej = e.drain_strict(s, delta)
    assert _mismatches(ref, f"{tag}/alive", s) == []
    assert _mismatches(ref, f"{tag}/alive_esc2", esc) == []
    for name, x in (("ok", ok), ("total", total), ("rej", rej)):
        want = ref[f"{tag}/alive_{name}"]
        assert x.numpy().dtype == want.dtype
        assert np.array_equal(x.numpy(), want), name
    assert rej.shape == (R,) and not ok[8:16].any() and ok.any()


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("layout", ["sparse", "dense"])
@pytest.mark.parametrize("R", SHARDS)
def test_run_loop_per_replica_knobs_match_reference(ref, R, layout, knob):
    """``run_loop`` with the per-replica adaptive refresh (it refreshes as
    soon as any replica's abort rate since the last refresh crosses the
    rate) and with replica 1 dead in every refresh, through the loop."""
    over = dict(KNOBS[knob])
    if "alive" in over:
        alive = torch.ones(R, dtype=torch.int32)
        alive[1] = 0
        over["alive"] = alive
    else:
        over["refresh_abort_rate"] = over["refresh_abort_rate"][R]
    e = _escrow_engine(R, layout)
    s0 = tt.init_state(SCALE, device="cpu")
    s0.s_quantity.mul_(3)
    s, esc, st = run_loop(e, s0, audit=True, **dict(ESCROW, **over))
    tag = f"R{R}/{layout}/{knob}"
    assert _mismatches(ref, tag, s) == []
    assert _mismatches(ref, f"{tag}/esc", esc) == []
    assert _counts(st) == ref[f"{tag}/counts"].tolist()
    if knob == "adaptive":
        assert 0 < st.refreshes < st.anti_entropy_rounds
    else:
        assert int(esc.shares[1].sum()) == 0 and esc.shares[0].sum() > 0


@pytest.mark.parametrize("strict", [False, True], ids=["merge", "strict"])
@pytest.mark.parametrize("R", SHARDS)
def test_twopc_matches_reference(ref, R, strict):
    two = TwoPCEngine(SCALE, strict_stock=strict, device="cpu", n_shards=R)
    q0 = tt.init_state(SCALE, device="cpu").s_quantity
    s, st = run_closed_loop_2pc(two, tt.init_state(SCALE, device="cpu"),
                                **TWOPC)
    tag = f"R{R}/2pc{int(strict)}"
    assert _mismatches(ref, tag, s) == []
    assert [st.committed, st.aborted, st.batches] == \
        ref[f"{tag}/counts"].tolist()
    if strict:
        from repro_torch.txn.audit import assert_audit
        assert_audit(s, initial_stock=q0, strict_stock=True)
        assert st.aborted > 0


@pytest.mark.parametrize("R", SHARDS)
def test_read_step_matches_reference(ref, R):
    """2PC's read (grant all-gather, per-shard RAMP read, vote) and the
    engine's Order-Status, on the merge mix's final state."""
    e = Engine(SCALE, device="cpu", n_shards=R)
    s, _, _ = run_loop(e, tt.init_state(SCALE, device="cpu"), **MERGE, **MIX)
    osb = tt.home_partitioned(tt.generate_order_status,
                              np.random.default_rng(9), e, 8)
    assert _mismatches(ref, f"R{R}/os_batch", osb) == []
    got = TwoPCEngine(SCALE, device="cpu", n_shards=R).read_step(s, osb)
    want = e.order_status_step(s, osb)
    assert _mismatches(ref, f"R{R}/read_step", got) == []
    assert _mismatches(ref, f"R{R}/os", want) == []
    assert int(got.found.sum()) > 0
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("R", [1, 2, 4])
def test_structural_proofs(R):
    """The hot paths of both regimes (both escrow layouts) and the RAMP
    reads call no collective, and each shard's body leaves its result and
    the scrambled foreign slices unchanged; anti-entropy, the refresh and
    both 2PC paths call collectives."""
    merge = Engine(SCALE, device="cpu", n_shards=R)
    assert merge.prove_coordination_free(4) == \
        "collectives: NONE (coordination-free)"
    assert merge.prove_read_coordination_free(4) == (
        "order-status: collectives: NONE (coordination-free); "
        "stock-level: collectives: NONE (coordination-free)")
    ae = merge.count_anti_entropy_collectives(4)
    assert ae.counts == {"all-gather": 4}
    for layout, kind in (("sparse", "all-reduce"), ("dense", "all-gather")):
        esc = _escrow_engine(R, layout, "kernel", "fused")
        assert "NONE" in esc.prove_coordination_free(4)
        assert esc.count_refresh_collectives().counts == {kind: 1}
    for strict in (False, True):
        two = TwoPCEngine(SCALE, strict_stock=strict, device="cpu",
                          n_shards=R)
        hot = two.hot_path_collectives(4)
        assert hot.total_ops > 0 and hot.counts["all-reduce"] == 1
        # strict: every field of the batch and every table gathered
        assert hot.counts["all-gather"] == (
            len(tt.NewOrderBatch._fields) + len(tt.TPCCState._fields)
            if strict else len(tt.StockDelta._fields))
    reader = TwoPCEngine(SCALE, device="cpu", n_shards=R)
    read = reader.read_path_collectives(4)
    assert read.counts == {"all-gather": 1, "all-reduce": 1}


class _ReadsForeign(Engine):
    """A faulty body: its totals read the next shard's warehouse."""

    def _neworder_shard(self, state, r, batch):
        delta, total = super()._neworder_shard(state, r, batch)
        s = (r + 1) % self.n_shards
        return delta, total + state.w_ytd[s * self.w_per_shard]


class _WritesForeign(Engine):
    """A faulty body: it writes into the next shard's stock."""

    def _neworder_shard(self, state, r, batch):
        s = (r + 1) % self.n_shards
        state.s_ytd[s * self.w_per_shard] += 1.0
        return super()._neworder_shard(state, r, batch)


@pytest.mark.parametrize("faulty", [_ReadsForeign, _WritesForeign])
def test_proof_catches_a_body_outside_its_slice(faulty):
    with pytest.raises(AssertionError, match="outside its slice"):
        faulty(SCALE, device="cpu", n_shards=2).prove_coordination_free(4)


def test_shards_must_divide_the_warehouses():
    for make in (lambda: Engine(SCALE, device="cpu", n_shards=3),
                 lambda: TwoPCEngine(SCALE, device="cpu", n_shards=3)):
        with pytest.raises(ValueError, match="not divisible by 3 shards"):
            make()


def test_shard_views_write_through_or_refuse():
    """A shard's view of a column-major table would not write through:
    ``shard_view`` refuses it, and ``shard_state`` makes it contiguous."""
    e = Engine(SCALE, device="cpu", n_shards=2)
    state = tt.init_state(SCALE, device="cpu")
    bad = state._replace(s_quantity=state.s_quantity.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        e.shard_view(bad, 1)
    view = e.shard_view(e.shard_state(bad), 1)
    view.s_quantity.add_(1)
    assert torch.equal(view.s_quantity, state.s_quantity[4:] + 1)


def test_collectives_gather_views_without_copy_and_count():
    table = torch.arange(24, dtype=torch.int32).reshape(8, 3)
    with collectives.counted() as stats:
        whole = collectives.all_gather([table[:4], table[4:]])
        apart = collectives.all_gather([table[4:], table[:4]])
        total = collectives.psum([table[:4], table[4:]])
    assert whole.data_ptr() == table.data_ptr() and torch.equal(whole, table)
    assert torch.equal(apart, torch.cat([table[4:], table[:4]]))
    assert torch.equal(total, table[:4] + table[4:])
    assert stats.counts == {"all-gather": 2, "all-reduce": 1}
    assert stats.bytes["all-gather"] == 2 * 96
    assert stats.describe().startswith("collectives: all-gather×2")
    with collectives.counted() as none:
        pass
    assert none.total_ops == 0
    assert none.describe() == "collectives: NONE (coordination-free)"
