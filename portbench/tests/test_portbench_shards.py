"""The harness at R warehouse shards, in the merge regime: the streams in
the port's layout, the relabelling within each shard, the reference
against the port's eager CPU path at R = 2 and 4 (the drains applying
real cross-shard deltas), the faults of the drain's exchange, the
configurations the harness refuses, and at R = 1 the draws, tables and
reference bit for bit as before shards (digests taken before the
harness took R)."""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.txn import engine as engine_mod
from repro_torch.txn import tpcc
from repro_torch.txn.drivers import generate_mix_batches, run_loop
from repro_torch.txn.engine import Engine

from portbench import run
from portbench.frozen import tpcc_inputs
from portbench.tests.tiny import (BENCH, CELLS, SCALE, cell, drive_cfg,
                                  driver, tiny)


def sharded(workload: str, n_shards: int, **traffic):
    """A cell's configuration at ``n_shards`` shards and the tiny size,
    with ``traffic`` over its traffic file."""
    _, cfg, base = run.cell_files(BENCH, workload)
    return tiny(dict(cfg, n_shards=n_shards), dict(base, **traffic))


def digest(*objs) -> str:
    """A short hash of arrays, dicts, lists and dataclasses, by dtype,
    shape and bytes."""
    h = hashlib.sha256()

    def feed(x):
        if x is None:
            h.update(b"None;")
        elif isinstance(x, dict):
            h.update(b"{")
            for k in sorted(x):
                h.update(str(k).encode() + b":")
                feed(x[k])
            h.update(b"}")
        elif isinstance(x, (list, tuple)):
            h.update(b"[")
            for y in x:
                feed(y)
            h.update(b"]")
        elif dataclasses.is_dataclass(x):
            feed({f.name: getattr(x, f.name) for f in dataclasses.fields(x)})
        else:
            a = np.ascontiguousarray(x)
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(a.tobytes())

    for o in objs:
        feed(o)
    return h.hexdigest()[:16]


# -- R = 1: as before shards -------------------------------------------------

# each cell at the tiny size: its inputs on two seeds, its initial tables
# and the reference's pass in float32 and in bfloat16 (seed 3); taken on
# the harness before it took R
R1_TINY = {
    "merge.neworder": ("919e70560264951e", "b1e3ecb8d03a2260",
                       "83486b195f00a8d3", "94f0b41d20b598a3",
                       "d78a733a20fc307d"),
    "escrow.neworder": ("9e4bafaffc2290ff", "e81166b00122e8d0",
                        "3c0eb3f84e9e4818", "798f3e827bd152b4",
                        "912af0db58fe7ece"),
    "merge.mix": ("41a661e1a9e8ac6e", "826dd2b2b1ef8a36",
                  "c715a6b61271b355", "ba0dd4f76dab5b28",
                  "e13b103037c2438a"),
    "escrow.uniform": ("919e70560264951e", "b1e3ecb8d03a2260",
                       "83486b195f00a8d3", "d318b5f03a798cac",
                       "f3bc9ca754f1d721"),
}
# each cell's inputs at its own size, seed 2**31 + 11
R1_SPEC = {"merge.neworder": "f94a4103cca14938",
           "merge.mix": "94c5c2ae37391251",
           "escrow.neworder": "0a8659d96529dbd2"}
# a stream of 8 warehouses, half its lines remote, Zipf items, and its
# relabelling: without reads, then with
R1_STREAM = {False: ("46ae4ec5af52e914", "4a99e68c5e17ef8f"),
             True: ("83ec81853530dd29", "d88bc88175dbc234")}


@pytest.mark.parametrize("workload", sorted(R1_TINY))
def test_r1_tiny_cells_as_before(workload):
    assert workload in CELLS
    cfg, traffic = cell(workload)
    mod = driver(cfg)
    got = [digest(mod.make_inputs(cfg, traffic, seed))
           for seed in (3, 2**31 + 5)]
    judged, initial = mod.initial_tables(cfg, traffic, 3, "cpu")
    got.append(digest(judged, initial))
    for precision in ("float32", "bfloat16"):
        r = mod.replay(cfg, traffic, initial, judged, precision)
        got.append(digest(r.tables, r.counters, r.shares, r.spent,
                          r.read_lines))
    assert tuple(got) == R1_TINY[workload]


@pytest.mark.parametrize("workload", sorted(R1_SPEC))
def test_r1_spec_inputs_as_before(workload):
    _, cfg, traffic = run.cell_files(BENCH, workload)
    assert cfg["n_shards"] == 1
    got = digest(driver(cfg).make_inputs(cfg, traffic, 2**31 + 11))
    assert got == R1_SPEC[workload]


@pytest.mark.parametrize("reads", [False, True])
def test_r1_stream_and_relabel_as_before(reads):
    scale = tpcc_inputs.Scale(**dict(SCALE, n_warehouses=8))
    s = tpcc_inputs.pass_stream(
        tpcc_inputs.rng_for(9, 1), scale, batch=8, n_batches=4,
        remote_frac=0.5, item_skew=1.2, payments=True, reads=reads,
        read_frac=0.5, ts0=5)
    d = tpcc_inputs.initial_draws(scale, tpcc_inputs.rng_for(9, 0), 3)
    got = (digest(s), digest(tpcc_inputs.relabel(
        scale, d, s, tpcc_inputs.rng_for(9, 2))))
    assert got == R1_STREAM[reads]


# -- the stream and the relabelling at R shards -----------------------------

SCALE8 = dict(SCALE, n_warehouses=8)


def _stream(n_shards: int, reads: bool, seed: int = 4, skew: float = 0.0,
            payments: bool = True):
    return tpcc_inputs.pass_stream(
        np.random.default_rng(seed), tpcc_inputs.Scale(**SCALE8), batch=8,
        n_batches=3, remote_frac=0.5, item_skew=skew, payments=payments,
        reads=reads, read_frac=0.5, n_shards=n_shards)


def _eq(frozen: dict, port) -> None:
    for f in port._fields:
        np.testing.assert_array_equal(frozen[f], getattr(port, f).numpy(),
                                      err_msg=f)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("skew", [0.0, 1.2])
def test_mix_stream_is_the_ports_at_r_shards(n_shards, skew):
    """``generate_mix_batches`` on an engine of R shards, draw for draw:
    2 rows a shard a batch, 1 read a shard."""
    eng = Engine(tpcc.TPCCScale(**SCALE8), n_shards=n_shards, device="cpu")
    port = generate_mix_batches(eng, batch_per_shard=8 // n_shards,
                                n_batches=3, remote_frac=0.5, read_frac=0.5,
                                seed=4, item_skew=skew)
    s = _stream(n_shards, True, skew=skew)
    for mine, theirs in zip((s.neworder, s.payment, s.order_status,
                             s.stock_level), port, strict=True):
        for a, b in zip(mine, theirs, strict=True):
            _eq(a, b)


@pytest.mark.parametrize("payments", [False, True])
def test_neworder_stream_is_the_ports_at_r_shards(payments, monkeypatch):
    """``run_loop``'s own stream at R = 4: the New-Order batches, then the
    Payment batches, from one generator."""
    seen = {}

    def capture(engine, state, esc, no_b, pay_b, os_b, sl_b, **kw):
        seen.update(no=no_b, pay=pay_b)
        raise StopIteration

    from repro_torch.txn import drivers
    monkeypatch.setattr(drivers, "_fused_loop", capture)
    scale = tpcc.TPCCScale(**SCALE8)
    eng = Engine(scale, n_shards=4, device="cpu")
    with pytest.raises(StopIteration):
        run_loop(eng, tpcc.init_state(scale, device="cpu"), batch_per_shard=2,
                 n_batches=3, seed=4, remote_frac=0.5, payments=payments)
    s = _stream(4, False, payments=payments)
    for a, b in zip(s.neworder, seen["no"], strict=True):
        _eq(a, b)
    assert (s.payment is None) == (seen["pay"] is None)
    for a, b in zip(s.payment or [], seen["pay"] or [], strict=True):
        _eq(a, b)


def _home(b: dict, n_shards: int) -> np.ndarray:
    return b["w"] // (SCALE8["n_warehouses"] // n_shards)


def _cross(b: dict, n_shards: int) -> np.ndarray:
    wps = SCALE8["n_warehouses"] // n_shards
    return b["supply_w"] // wps != (b["w"] // wps)[:, None]


def test_stream_layout_at_four_shards():
    """Each batch is four parts of two rows, part r homed in shard r,
    stamped one after another; supply warehouses drawn over all eight,
    so some lines cross shards."""
    s = _stream(4, True)
    for b in s.neworder:
        assert _home(b, 4).tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    ts = np.concatenate([b["ts"] for b in s.neworder])
    assert ts.tolist() == list(range(len(ts)))
    assert any(_cross(b, 4).any() for b in s.neworder)
    for kind in (s.payment, s.order_status, s.stock_level):
        for b in kind:
            rows = len(b["w"]) // 4
            assert (_home(b, 4) == np.repeat(np.arange(4), rows)).all()


def test_relabel_keeps_each_rows_shard():
    """Relabelling at R = 4 moves warehouses within their shard: every row
    keeps its home shard, every line its cross-shard status, and the
    tables move with the names."""
    scale = tpcc_inputs.Scale(**SCALE8)
    s = _stream(4, True)
    d = tpcc_inputs.initial_draws(scale, np.random.default_rng(1))
    d2, s2 = tpcc_inputs.relabel(scale, d, s, np.random.default_rng(7), 4)
    moved = False
    for kind in ("neworder", "payment", "order_status", "stock_level"):
        for a, b in zip(getattr(s, kind), getattr(s2, kind), strict=True):
            assert (_home(a, 4) == _home(b, 4)).all()
            moved |= bool((a["w"] != b["w"]).any())
            if kind == "neworder":
                assert (_cross(a, 4) == _cross(b, 4)).all()
                np.testing.assert_array_equal(a["i_id"], b["i_id"])
    assert moved
    for a, b in zip(s.neworder, s2.neworder):
        np.testing.assert_array_equal(d.s_quantity[a["supply_w"], a["i_id"]],
                                      d2.s_quantity[b["supply_w"], b["i_id"]])
        np.testing.assert_array_equal(d.w_tax[a["w"]], d2.w_tax[b["w"]])


# -- the reference against the port at R shards ------------------------------

@pytest.mark.parametrize("seed", [3, 2**31 + 5])
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("workload", ["merge.neworder", "merge.mix"])
def test_port_matches_reference_at_r_shards(workload, n_shards, seed):
    rec = drive_cfg(*sharded(workload, n_shards), seed)
    assert rec.correct, rec.checks
    assert rec.reference.counters["neworders"] > 0
    assert rec.program["tables"]["s_quantity"].shape[0] == 4


@pytest.mark.parametrize("n_shards", [2, 4])
def test_drains_apply_cross_shard_deltas(n_shards):
    """Half the lines remote, 20 items: the drains apply real cross-shard
    deltas, cells fall below 10 and restock, and the port agrees with the
    reference to the bit."""
    cfg, traffic = sharded("merge.neworder", n_shards, remote_frac=0.5)
    cfg["scale"]["n_items"] = 20
    seed = 2**31 + 9
    rec = drive_cfg(cfg, traffic, seed)
    assert rec.correct, rec.checks
    assert rec.reference.drained > 50
    t = rec.program["tables"]
    # every drained line counts as remote at its owner
    assert int(t["s_remote_cnt"].sum()) >= rec.reference.drained
    # the units ordered less the stock's fall: 91 a restock
    _, initial = driver(cfg).initial_tables(cfg, traffic, seed, "cpu")
    fell = int(initial["s_quantity"].sum()) - int(t["s_quantity"].sum())
    ordered = int(t["s_ytd"].sum())
    assert ordered > fell and (ordered - fell) % 91 == 0


# -- the faults of the drain's exchange --------------------------------------

def _first_live(valid: torch.Tensor) -> torch.Tensor:
    """A mask of the first live lane of ``valid`` (flat)."""
    flat = valid.reshape(-1)
    return flat & (flat.cumsum(0) == 1)


def _dropped(monkeypatch):
    """The first live cross-shard delta of every drain left out."""
    apply = engine_mod.gather_and_apply_outbox

    def dropped(state, outbox, *a, **k):
        valid = outbox.valid.reshape(-1) & ~_first_live(outbox.valid)
        flat = type(outbox)(*(x.reshape(-1) for x in outbox[:3]), valid)
        return apply(state, flat, *a, **k)
    monkeypatch.setattr(engine_mod, "gather_and_apply_outbox", dropped)


def _doubled(monkeypatch):
    """The first live cross-shard delta of every drain applied twice."""
    apply = engine_mod.gather_and_apply_outbox

    def doubled(state, outbox, *a, **k):
        apply(state, outbox, *a, **k)
        flat = type(outbox)(*(x.reshape(-1) for x in outbox[:3]),
                            _first_live(outbox.valid))
        return apply(state, flat, *a, **k)
    monkeypatch.setattr(engine_mod, "gather_and_apply_outbox", doubled)


def _at_home(monkeypatch):
    """Each shard's first committed cross-shard line of a batch applied at
    its home warehouse, as if local, and never sent to its owner."""
    flatten = tpcc.flatten_order_lines

    def at_home(batch, w_lo, w_hi):
        f = flatten(batch, w_lo, w_hi)
        valid = tpcc.order_line_valid(batch).reshape(-1)
        first = _first_live(valid & ~f.local)
        home = batch.w[:, None].expand_as(batch.supply_w).reshape(-1)
        return f._replace(w=torch.where(first, home, f.w),
                          local=f.local | first)
    monkeypatch.setattr(tpcc, "flatten_order_lines", at_home)


EXCHANGE_FAULTS = {"dropped": _dropped, "doubled": _doubled,
                   "at_home": _at_home}


@pytest.mark.parametrize("fault", [None, *sorted(EXCHANGE_FAULTS)])
def test_exchange_fault_is_not_correct(fault, monkeypatch):
    """Each fault reads not correct; the same run with nothing planted
    reads correct."""
    if fault is not None:
        EXCHANGE_FAULTS[fault](monkeypatch)
    rec = drive_cfg(*sharded("merge.neworder", 4, remote_frac=0.5), 21)
    assert rec.correct is (fault is None), rec.checks
    assert rec.reference.drained > 0


# -- what the harness refuses ------------------------------------------------

def _refused(cfg, traffic) -> str:
    with pytest.raises(SystemExit) as e:
        driver(cfg).make_inputs(cfg, traffic, 1)
    return str(e.value)


@pytest.mark.parametrize("workload", ["escrow.neworder", "escrow.uniform"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_escrow_at_r_shards_is_refused(workload, n_shards):
    msg = _refused(*sharded(workload, n_shards))
    assert "tpcc-w256-escrow" in msg and "per-replica shares" in msg


@pytest.mark.parametrize("n_warehouses,batch,n_shards", [
    (3, 8, 2), (6, 8, 4), (4, 6, 4), (8, 10, 4)])
def test_shards_must_divide_warehouses_and_batch(n_warehouses, batch,
                                                 n_shards):
    cfg, traffic = sharded("merge.neworder", n_shards, batch=batch)
    cfg["scale"]["n_warehouses"] = n_warehouses
    traffic["batch"] = batch
    msg = _refused(cfg, traffic)
    assert "tpcc-w256-merge" in msg and "divide" in msg


def test_tiny_size_divides_into_the_shards():
    assert [sharded("merge.neworder", r)[0]["scale"]["n_warehouses"]
            for r in (1, 2, 4)] == [3, 4, 4]
    assert cell("merge.neworder")[0]["scale"] == SCALE
