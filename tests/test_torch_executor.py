"""The fused executor (``txn/executor.py``) and the driver API against the
JAX package's.

``run_loop(fused=True)``, the port's default as the reference's, runs the
stream in chunks of ``merge_every`` batches (on the card one CUDA graph
replay a chunk; here, on the CPU, the same chunk body eagerly), then the
drain and refresh at the host's cadence. Each case runs one seeded stream
through the port and through the reference, ``fused=True`` and
``fused=False`` (and ``legacy=True`` where it says so), at R = 1, 2 and 4:

* merge and escrow, sparse and dense, New-Order alone and the mix, with a
  shorter last chunk;
* the cold-retry ring (``retry_cap``, ``retry_max``, ``retry_reserve``)
  with a lease monitor whose source stops one replica's beats
  (``liveness``), a ring small enough to overflow, a dead replica
  (``alive``) and the adaptive refresh (``refresh_abort_rate``);
* the item-15 wrappers (``run_closed_loop``, ``run_mixed_loop``,
  ``run_escrow_loop``, ``run_fused_loop``, ``run_fused_escrow_loop``) and
  ``legacy=True``.

The reference runs in three subprocesses started with the module's first
test (R = 1 on one CPU device, R = 2 and 4 on simulated devices,
``--xla_force_host_platform_device_count=4``), beside the tests that need
none of it: a chunk longer than the ring is refused, a chunk calls no
collective and each drain calls what the dispatch path's calls, the fixed
buffers keep their addresses, Payment's static round count gives the
floats of the dynamic one, the refresh writes into the live escrow, the
chunk body makes no host read (what lets a CUDA graph capture it), and a
second call on the same tables keeps the first call's ring, counters and
commit-mask buffer, zeroed, where new tables or batch shapes get new ones.

Tolerance: exact, values and dtypes. Integers and bools are equal; so are
the floats: the integer-valued adds (``s_ytd``, stock) are exact in any
order below 2**24 (``src/repro/kernels/txn_megastep.py:37-43``), and the
others (Payment, totals, balances) add in the reference's order. One
exception is the reference's own: the fused path gathers the ring of
outboxes shard-major and the dispatch path row-major, so at R > 1 the
cold-retry ring holds the same entries an owner in another lane order;
there the port's fused ring equals the reference's fused ring bit for bit
and the dispatch rings lane for lane after sorting, where no ring
overflowed.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side, in subprocesses

from repro_torch.convert import state_to_numpy  # noqa: E402
from repro_torch.core.lattice import pack_lease_stamp  # noqa: E402
from repro_torch.runtime.liveness import LeaseMonitor  # noqa: E402
from repro_torch.txn import drivers, executor  # noqa: E402
from repro_torch.txn import tpcc as tt  # noqa: E402
from repro_torch.txn.engine import Engine  # noqa: E402
from repro_torch.txn.audit import assert_audit  # noqa: E402
from repro_torch.txn.drivers import counters_to_stats  # noqa: E402
from repro_torch.txn.executor import (FusedExecutor,  # noqa: E402
                                      get_fused_executor, stack_chunks)

ROOT = Path(__file__).resolve().parents[1]
SCALE = [8, 4, 8, 64, 64, 15]
RING_SCALE = [4, 2, 8, 32, 512, 15]
MIX = dict(payments=True, reads=True, deliveries=True)
STRICT = dict(stock_invariant="strict")
# name -> (scale, engine knobs, run_loop knobs). Chunks of merge_every with
# a shorter last one; "ring" adds the lease monitor (``LIVE``).
CONFIGS = {
    "merge_mix": (SCALE, {}, dict(batch_per_shard=8, n_batches=5,
                                  merge_every=2, remote_frac=0.3, seed=3,
                                  **MIX)),
    "merge_neworder": (SCALE, {}, dict(batch_per_shard=8, n_batches=6,
                                       merge_every=4, remote_frac=0.3,
                                       seed=11)),
    "sparse_mix": (SCALE, dict(STRICT, hot_items=4, admission="kernel",
                               effects="fused"),
                   dict(batch_per_shard=8, n_batches=6, merge_every=4,
                        refresh_every=2, remote_frac=0.5, seed=5,
                        item_skew=1.2, **MIX)),
    "sparse_knobs": (SCALE, dict(STRICT, hot_items=4, admission="kernel",
                                 effects="scan"),
                     dict(batch_per_shard=8, n_batches=8, merge_every=2,
                          remote_frac=0.5, seed=6, item_skew=1.2,
                          refresh_abort_rate=0.3, alive="dead 1")),
    "dense": (SCALE, dict(STRICT, escrow_layout="dense"),
              dict(batch_per_shard=8, n_batches=5, merge_every=2,
                   refresh_every=2, remote_frac=0.3, seed=3, **MIX)),
    "ring": (RING_SCALE, STRICT,
             dict(batch_per_shard=8, n_batches=12, merge_every=4,
                  refresh_every=1, remote_frac=0.6, seed=3, item_skew=1.5,
                  retry_cap=256, retry_max=3, retry_reserve=1,
                  liveness="stop beat")),
    "ring_overflow": (RING_SCALE, STRICT,
                      dict(batch_per_shard=8, n_batches=8, merge_every=4,
                           refresh_every=1, remote_frac=0.9, seed=3,
                           item_skew=1.5, retry_cap=2, retry_max=1,
                           final_flush=False)),
}
LIVE = dict(expiry=0, hysteresis=1, stop=1)
# the reference runs every config fused; these by dispatch too, and at R = 1
# the LEGACY ones with legacy=True (its fused runs compile for seconds each,
# so the dispatch runs are a subset: the others' dispatch path is held to
# the reference's in tests/test_torch_shards.py and test_torch_retry.py)
DISPATCH = {1: ["merge_mix", "sparse_mix", "dense"],
            2: ["sparse_knobs", "ring"],
            4: ["merge_mix", "ring", "ring_overflow"]}
LEGACY = ("merge_mix", "sparse_mix")
COUNTS = ("neworders", "aborts", "cold_rejects", "refreshes",
          "anti_entropy_rounds", "payments", "order_statuses",
          "stock_levels", "deliveries", "reads_found", "fractures_observed",
          "lines_repaired")
SHARDS = [1, 2, 4]


def stop_beat(R, dead, stop, pack):
    """A lease source: every replica beats once a window, but ``dead``'s
    stamp stops advancing at window ``stop`` (the reference's script runs
    this same function)."""
    def source(window):
        seq = np.full(R, window + 1, np.int64)
        seq[dead] = min(window, stop - 1) + 1
        return np.asarray(pack(0, seq), np.int64)
    return source


def knobs_for(kw, R, monitor, alive):
    """A config's run_loop knobs at R shards: "dead 1" is replica 1 dead
    (none at R = 1), "stop beat" a ``monitor`` from :func:`stop_beat`."""
    kw = dict(kw)
    if kw.get("alive") == "dead 1":
        kw["alive"] = alive(R) if R > 1 else None
    if kw.get("liveness") == "stop beat":
        kw["liveness"] = monitor(R, expiry=LIVE["expiry"],
                                 hysteresis=LIVE["hysteresis"],
                                 source=stop_beat(R, min(2, R - 1),
                                                  LIVE["stop"],
                                                  pack_lease_stamp))
    return kw


_REFERENCE = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core.lattice import pack_lease_stamp
from repro.runtime.liveness import LeaseMonitor
from repro.txn import tpcc
from repro.txn.drivers import run_loop
from repro.txn.engine import Engine

configs, dispatch, legacy, R = (json.loads(a) for a in sys.argv[2:6])
COUNTS = %r
exec(%r)
exec(%r)
mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
out, summary = {}, {}


def dead_one(R):
    alive = np.ones(R, np.int32)
    alive[1] = 0
    return alive


for name, (sc, ekw, kw) in configs.items():
    scale = tpcc.TPCCScale(*sc)
    e = Engine(scale, mesh, **ekw)
    modes = {"fused": dict(fused=True)}
    if name in dispatch:
        modes["dispatch"] = dict(fused=False)
    if R == 1 and name in legacy:
        modes["legacy"] = dict(legacy=True)
    for mode, m in modes.items():
        knobs = knobs_for(kw, R, LeaseMonitor, dead_one)
        s0 = tpcc.init_state(scale)
        s, esc, st, ring = run_loop(e, e.shard_state(s0), return_retry=True,
                                    **m, **knobs)
        key = f"{name}/{mode}"
        for tag, tree in ((key, s), (key + "/esc", esc),
                          (key + "/ring", ring)):
            if tree is not None:
                for f, x in zip(tree._fields, jax.device_get(tree)):
                    out[f"{tag}/{f}"] = np.asarray(x)
        out[key + "/counts"] = np.array([getattr(st, k) for k in COUNTS])
        mon = knobs.get("liveness")
        summary[key] = [list(d) for d in mon.detections] if mon else None
np.savez(sys.argv[1], **out)
print(json.dumps(summary))
"""


def _script():
    import inspect
    return _REFERENCE % (COUNTS, "LIVE = " + repr(LIVE) + "\n"
                         + inspect.getsource(stop_beat),
                         inspect.getsource(knobs_for))


@pytest.fixture(scope="module", autouse=True)
def _reference_runs(tmp_path_factory):
    """Start the reference's runs at R = 1, 2 and 4 with the module's first
    test, three subprocesses at once, while the tests that need none of
    them run; :func:`ref` waits for them."""
    d = tmp_path_factory.mktemp("executor")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {}
    for R in SHARDS:
        log = open(d / f"R{R}.log", "w")
        procs[R] = (subprocess.Popen(
            [sys.executable, "-c", _script(), str(d / f"R{R}.npz"),
             json.dumps(CONFIGS), json.dumps(DISPATCH[R]),
             json.dumps(LEGACY), str(R)], env=env, stdout=log,
            stderr=subprocess.STDOUT, text=True), log)
    yield d, procs
    for p, log in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


@pytest.fixture(scope="module")
def ref(_reference_runs):
    """The reference's results: {R: (arrays by key, detections by
    key)}."""
    d, procs = _reference_runs
    out = {}
    for R, (p, log) in procs.items():
        rc = p.wait(timeout=600)
        log.flush()
        text = (d / f"R{R}.log").read_text()
        assert rc == 0, text[-3000:]
        with np.load(d / f"R{R}.npz") as data:
            out[R] = (dict(data), json.loads(text.strip().splitlines()[-1]))
    return out


def _mismatches(ref, tag, port):
    """Fields of ``port`` whose dtype, shape or value differ from the
    reference's under ``tag``."""
    port = state_to_numpy(port)
    return [f for f, y in zip(port._fields, port)
            if ref[f"{tag}/{f}"].dtype != y.dtype
            or ref[f"{tag}/{f}"].shape != y.shape
            or not np.array_equal(ref[f"{tag}/{f}"], y)]


def _sorted_lanes(get):
    """Each owner's valid ring lanes (``get(field)`` its ``[R, C]``
    array) as a sorted list of tuples of every field."""
    fields = [np.asarray(get(f)) for f in tt.RetryState._fields]
    valid = np.asarray(get("valid"))
    return [sorted(zip(*(x[r][valid[r]].tolist() for x in fields)))
            for r in range(valid.shape[0])]


def _dead_one(R):
    alive = torch.ones(R, dtype=torch.int32)
    alive[1] = 0
    return alive


def _port(name, R, **mode):
    """The port's run of ``CONFIGS[name]`` at R shards on the CPU, audited
    (the escrow's coverage too where every replica lives): (state, escrow,
    stats, ring, detections)."""
    sc, ekw, kw = CONFIGS[name]
    e = Engine(tt.TPCCScale(*sc), device="cpu", n_shards=R, **ekw)
    knobs = knobs_for(kw, R, LeaseMonitor, _dead_one)
    s, esc, st, ring = drivers.run_loop(
        e, tt.init_state(e.scale, device="cpu"), return_retry=True,
        **mode, **knobs)
    if esc is None:
        assert_audit(s)
    else:
        dead = knobs.get("alive") is not None or "liveness" in knobs
        assert_audit(s, escrow=None if dead else esc, strict_stock=True,
                     initial_stock=tt.init_state(e.scale,
                                                 device="cpu").s_quantity)
    mon = knobs.get("liveness")
    return s, esc, st, ring, (None if mon is None
                              else [list(d) for d in mon.detections])


# ---------------------------------------------------------------------------
# the item-15 wrappers, against the reference's in this process
# ---------------------------------------------------------------------------

def _jax_side():
    import jax
    from repro.txn import drivers as jd
    from repro.txn import tpcc as jt
    from repro.txn.engine import single_host_engine
    return jax, jd, jt, single_host_engine


WRAPPERS = {
    "run_closed_loop": (
        {}, dict(batch_per_shard=8, n_batches=6, merge_every=3, seed=11,
                 payments=True, deliveries=True)),
    "run_mixed_loop": ({}, dict(batch_per_shard=8, n_batches=5,
                                merge_every=2, seed=3, remote_frac=0.3)),
    "run_escrow_loop": (dict(STRICT, hot_items=4, admission="kernel"),
                        dict(batch_per_shard=8, n_batches=5, merge_every=2,
                             refresh_every=2, seed=3, remote_frac=0.3)),
    "run_fused_loop": ({}, dict(batch_per_shard=8, n_batches=8,
                                merge_every=8, seed=2)),
    "run_fused_escrow_loop": (dict(STRICT, hot_items=4, admission="kernel"),
                              dict(batch_per_shard=8, n_batches=4,
                                   merge_every=2, seed=2, mix=False)),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_driver_wrappers_match_reference(name):
    """Each public wrapper on the same seed in both packages (R = 1, the
    reference in this process): the same state, escrow and stats; where it
    takes ``fused``, ``legacy=True`` (mixed and escrow loops) and
    ``fused=False`` too."""
    jax, jd, jt, jengine = _jax_side()
    ekw, kw = WRAPPERS[name]
    je = jengine(jt.TPCCScale(*SCALE), **ekw)
    te = Engine(tt.TPCCScale(*SCALE), device="cpu", **ekw)
    modes = [{}]
    if name in ("run_closed_loop", "run_mixed_loop", "run_escrow_loop"):
        modes.append(dict(fused=False))
    if name in ("run_mixed_loop", "run_escrow_loop"):
        modes.append(dict(legacy=True))
    want = getattr(jd, name)(je, je.shard_state(jt.init_state(je.scale)),
                             **kw)
    for mode in modes:
        got = getattr(drivers, name)(
            te, tt.init_state(te.scale, device="cpu"), **kw, **mode)
        assert type(got) is tuple and len(got) == len(want)
        j_esc = want[1] if len(want) == 3 else None
        t_esc = got[1] if len(got) == 3 else None
        for tag, j, t in (("s", want[0], got[0]), ("e", j_esc, t_esc)):
            if j is not None:
                host = {f"{tag}/{f}": np.asarray(x)
                        for f, x in zip(j._fields, jax.device_get(j))}
                assert _mismatches(host, tag, t) == [], (tag, mode)
        js, ts = want[-1], got[-1]
        fields = [f for f in type(ts).__dataclass_fields__
                  if f != "wall_seconds"]
        assert [getattr(ts, f) for f in fields] == \
            [getattr(js, f) for f in fields], mode
        assert ts.wall_seconds > 0


def test_closed_loop_refuses_the_mix_in_the_escrow_regime():
    e = Engine(tt.TPCCScale(*SCALE), device="cpu", **STRICT)
    with pytest.raises(NotImplementedError, match="run_escrow_loop"):
        drivers.run_closed_loop(e, tt.init_state(e.scale, device="cpu"),
                                batch_per_shard=2, n_batches=1,
                                payments=True)
    merge = Engine(tt.TPCCScale(*SCALE), device="cpu")
    with pytest.raises(RuntimeError, match="not escrow"):
        drivers.run_escrow_loop(merge, tt.init_state(merge.scale,
                                                     device="cpu"),
                                batch_per_shard=2, n_batches=1)


# ---------------------------------------------------------------------------
# the executor's own contract, on the port alone
# ---------------------------------------------------------------------------

def _chunks(e, n_batches, merge_every, bps=4, seed=0, **kw):
    no_b, pay_b, os_b, sl_b = drivers.generate_mix_batches(
        e, batch_per_shard=bps, n_batches=n_batches, seed=seed, **kw)
    return stack_chunks(no_b, pay_b, os_b, sl_b, merge_every)


def _engine(R=1, **kw):
    return Engine(tt.TPCCScale(*SCALE), device="cpu", n_shards=R, **kw)


def test_chunk_longer_than_ring_rejected():
    e = _engine()
    ex = FusedExecutor(e, ring_rows=2)
    chunk = _chunks(e, 3, 3)[0]
    state = tt.init_state(e.scale, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        ex.megastep(state, ex.init_ring(4), ex.init_counters(), chunk)
    with pytest.raises(ValueError, match="exceeds"):
        ex.run(state, [chunk])
    with pytest.raises(ValueError, match="exceeds"):
        ex.prove_megastep_coordination_free(chunk_len=3)


def test_regime_entry_points_refuse_the_other_regime():
    e = _engine(**STRICT)
    ex = FusedExecutor(e, ring_rows=4)
    state = tt.init_state(e.scale, device="cpu")
    with pytest.raises(RuntimeError, match="use run_escrow"):
        ex.run(state, [])
    with pytest.raises(RuntimeError, match="use run"):
        FusedExecutor(_engine(), ring_rows=4).run_escrow(state, None, [])
    with pytest.raises(ValueError, match="sparse"):
        FusedExecutor(_engine(escrow_layout="dense", **STRICT), retry_cap=4)
    with pytest.raises(RuntimeError, match="retry_cap=0"):
        ex.init_retry()


@pytest.mark.parametrize("R", SHARDS)
def test_chunk_calls_no_collective_and_drains_count_as_dispatch(R):
    """Definition 5 on the fused path: a chunk of the full mix calls no
    collective in either regime, both layouts. Each ring drain calls the
    collectives the dispatch path's drain calls: the same kinds and
    counts, the same bytes for a window of as many rows."""
    rows, bps = 4, 4
    merge = _engine(R)
    ex = FusedExecutor(merge, ring_rows=rows)
    assert ex.prove_megastep_coordination_free(rows, bps, 2) == \
        "collectives: NONE (coordination-free)"
    got = ex.count_drain_collectives(bps)
    want = merge.count_anti_entropy_collectives(bps * rows)
    assert got.counts == want.counts == {"all-gather": 4}
    assert got.bytes == want.bytes
    for layout in ("sparse", "dense"):
        e = _engine(R, escrow_layout=layout, hot_items=4, admission="kernel",
                    **STRICT)
        ex = FusedExecutor(e, ring_rows=rows,
                           retry_cap=8 if layout == "sparse" else 0)
        assert "NONE" in ex.prove_megastep_coordination_free(rows, bps, 2)
        strict = ex.count_drain_strict_collectives(bps)
        assert strict.counts == {"all-gather": 4}
        assert strict.bytes == want.bytes
        both = ex.count_drain_refresh_collectives(bps)
        refresh = e.count_refresh_collectives()
        assert both.counts == strict.counts + refresh.counts
        assert both.bytes == strict.bytes + refresh.bytes
        if layout == "sparse":
            retry = ex.count_drain_strict_retry_collectives(bps)
            assert retry.counts == strict.counts
            assert retry.bytes == strict.bytes


@pytest.mark.parametrize("regime", ["merge", "escrow"])
def test_fixed_buffers_keep_their_addresses(regime):
    """The analogue of donation: a chunk, a drain and a whole run update
    state, ring, counters, escrow and the retry ring in place; no leaf
    moves to a new allocation."""
    strict = regime == "escrow"
    e = _engine(2, **(dict(STRICT, hot_items=4, admission="kernel")
                      if strict else {}))
    ex = FusedExecutor(e, ring_rows=2, retry_cap=8 if strict else 0)
    chunk = _chunks(e, 2, 2)[0]
    state = tt.init_state(e.scale, device="cpu")
    ring, counters = ex.init_ring(4), ex.init_counters()
    esc = e.init_escrow(state) if strict else None
    leaves = lambda *ts: [x.data_ptr() for t in ts if t is not None  # noqa
                          for x in t]
    before = leaves(state, ring, counters, esc)
    if strict:
        retry = ex.init_retry()
        out = ex.megastep_escrow(state, ring, counters, esc, chunk)
        r_before = leaves(retry)
        out2 = ex.drain_refresh_retry(out[0], out[1], retry, out[3])
        assert leaves(out2[2]) == r_before
        assert leaves(out2[0], out2[1], counters, out2[3]) == before
    else:
        out = ex.megastep(state, ring, counters, chunk)
        out2 = ex.drain(out[0], out[1])
        assert leaves(out2[0], out2[1], out[2]) == before
    assert not ring.valid.any()
    assert int(counters.neworders.sum() + counters.aborts.sum()) == 8 * 2
    chunks = _chunks(e, 5, 2)
    if strict:
        s, e2, c, _, _, _, r = ex.run_escrow(state, esc, chunks, retry=retry)
        assert leaves(s, e2) == leaves(state, esc)
    else:
        s, c, _ = ex.run(state, chunks)
        assert leaves(s) == leaves(state)


def test_counters_accumulate_on_device():
    """MixStats from one host read of the ``[R]`` counter lanes."""
    e = _engine(2)
    ex = FusedExecutor(e, ring_rows=4)
    chunks = _chunks(e, 4, 4, bps=8, seed=7)
    state, counters, wall = ex.run(tt.init_state(e.scale, device="cpu"),
                                   chunks)
    assert all(x.shape == (2,) and x.dtype == torch.int32 for x in counters)
    stats = counters_to_stats(counters, anti_entropy_rounds=len(chunks),
                              wall_seconds=wall)
    assert stats.neworders == stats.payments == 2 * 8 * 4
    assert stats.order_statuses == stats.stock_levels == 2 * 2 * 4
    assert stats.fractures_observed == 0 and stats.deliveries > 0
    assert counters.neworders.tolist() == [32, 32]


def test_executor_is_built_once_an_engine_and_shape():
    e = _engine()
    a = get_fused_executor(e, ring_rows=4)
    assert get_fused_executor(e, ring_rows=4) is a
    assert get_fused_executor(e, ring_rows=2) is not a
    assert get_fused_executor(e, ring_rows=4, deliveries=False) is not a


def test_payment_static_rounds_give_the_dynamic_floats():
    """More chaining rounds than a batch needs change no bit, so the
    chunk's (or the stream's) deepest duplicate serves every batch."""
    e = _engine()
    rng = np.random.default_rng(0)
    pay = tt.generate_payment(rng, e.scale, 64, device="cpu")
    need = tt.payment_rounds(pay.w)
    assert need > 2
    outs = []
    for rounds in (None, need, need + 5):
        s = tt.init_state(e.scale, device="cpu")
        tt.apply_payment(s, pay, rounds=rounds)
        outs.append(s)
    for s in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(outs[0], s))
    # too few rounds lose adds: the count is not slack
    s = tt.init_state(e.scale, device="cpu")
    tt.apply_payment(s, pay, rounds=need - 1)
    assert not torch.equal(s.w_ytd, outs[0].w_ytd)
    chunk = _chunks(e, 3, 3, bps=32)[0]
    assert chunk.pay_rounds == tt.payment_rounds(chunk.payment.w)


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_refresh_writes_into_the_live_escrow(layout):
    """``Engine.refresh_escrow`` returns the escrow it was given, its
    tensors holding the fresh shares, equal to a refresh of a copy."""
    e = _engine(2, escrow_layout=layout, hot_items=4, **STRICT)
    state = tt.init_state(e.scale, device="cpu")
    esc = e.init_escrow(state)
    esc.spent.add_(1)
    state.s_quantity.sub_(3)
    copy = e.refresh_escrow(state, tt.copy_tree(esc), _dead_one(2))
    ptrs = [x.data_ptr() for x in esc]
    out = e.refresh_escrow(state, esc, _dead_one(2))
    assert out is esc and [x.data_ptr() for x in out] == ptrs
    assert all(torch.equal(x, y) for x, y in zip(out, copy))
    assert not esc.spent.any() and not esc.shares[1].any()


class _HostReads(torch.overrides.TorchFunctionMode):
    """Raises on every torch call that reads a tensor back to the host or
    copies host data to the device: what a CUDA graph cannot capture (a
    0-d integer index is read as an int; a bool mask needs a count)."""

    READS = {"item", "tolist", "numpy", "cpu", "nonzero", "unique",
             "masked_select", "__bool__", "__int__", "__float__",
             "__index__", "tensor"}

    def __init__(self):
        super().__init__()
        self.paused = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if not self.paused:
            bad = name in self.READS
            bad |= name == "as_tensor" and not torch.is_tensor(args[0])
            bad |= name == "where" and len(args) + len(kwargs) == 1
            bad |= name == "repeat_interleave" and "output_size" not in kwargs
            if name in ("__getitem__", "__setitem__", "index_put_",
                        "index_put"):
                idx = args[1] if isinstance(args[1], tuple) else (args[1],)
                bad |= any(torch.is_tensor(i) and (i.dtype == torch.bool or
                                                   i.dim() == 0)
                           for i in idx)
            if bad:
                raise AssertionError(f"host read in the chunk body: {name}")
        return func(*args, **kwargs)


@pytest.mark.parametrize("regime", ["merge", "sparse", "dense"])
def test_chunk_body_makes_no_host_read(monkeypatch, regime):
    """The chunk body, every transaction of the mix on two shards, calls
    nothing that reads back to the host, so a CUDA graph can capture it.
    The kernels' plain versions, which stand in for the kernels on the
    CPU, are exempt (on the card the kernels run)."""
    from repro_torch.kernels import ops
    ekw = {} if regime == "merge" else dict(
        STRICT, escrow_layout=regime, hot_items=4, admission="kernel",
        effects="fused")
    e = _engine(2, **ekw)
    ex = FusedExecutor(e, ring_rows=3)
    chunk = _chunks(e, 3, 3, bps=8, remote_frac=0.5)[0]
    state = tt.init_state(e.scale, device="cpu")
    esc = e.init_escrow(state) if regime != "merge" else None
    guard = _HostReads()

    def exempt(fn):
        def run(*a, **k):
            guard.paused += 1
            try:
                return fn(*a, **k)
            finally:
                guard.paused -= 1
        return run
    for name in ("residual_fcfs", "txn_megastep_plain", "ramp_read_plain"):
        monkeypatch.setattr(ops, name, exempt(getattr(ops, name)))
    # the probe is resolved before a capture, in the warm-up
    tt.resolve_admission(e.admission, 8, e.scale.max_lines, "cpu")
    ring, counters = ex.init_ring(8), ex.init_counters()
    with guard:
        ex._chunk(state, ring, counters, esc, chunk)
    assert int(counters.neworders.sum()) > 0 and ring.valid.any()
    # the guard has teeth: the dispatch path's Payment reads its depth
    with pytest.raises(AssertionError, match="host read"):
        with guard:
            e.payment_step(state, type(chunk.payment)(
                *(x[0] for x in chunk.payment)))


def test_fused_cpu_run_is_eager_and_timed():
    """On the CPU the executor runs the chunks eagerly: no graph is kept,
    and the run's wall time covers them."""
    e = _engine()
    ex = get_fused_executor(e, ring_rows=4)
    t0 = time.perf_counter()
    _, _, st = drivers.run_loop(e, tt.init_state(e.scale, device="cpu"),
                                batch_per_shard=4, n_batches=6,
                                merge_every=4, **MIX)
    assert 0 < st.wall_seconds < time.perf_counter() - t0
    assert ex.last_run == {} and st.anti_entropy_rounds == 2
    assert executor.launch_counts().keys() == {
        k.__name__ for k in executor.KERNELS} != set()


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("regime", ["merge", "escrow"])
def test_drain_lane_counters(monkeypatch, regime, R):
    """A metrics-on run's ``last_run["drain_lanes"]`` counts the lanes its
    drains' stock scatters took, every owner the whole ring (a drain at
    the benchmark's shape, 8 x 256 x 15, takes 30,720), and
    ``["drain_live_lanes"]`` the ring's live remote lines: in the merge
    regime the valid lines whose supply warehouse lies outside their home
    shard, in the escrow regime those of committed orders. At R = 1 every
    line is local and every lane masked. A metrics-off run counts
    nothing."""
    from repro_torch.obs import ObsSession

    strict = regime == "escrow"
    e = _engine(R, **(dict(STRICT, hot_items=4, admission="kernel")
                      if strict else {}))
    rows, bps = 4, 4
    ex = FusedExecutor(e, ring_rows=rows)
    chunks = _chunks(e, 7, rows, bps=bps, seed=5, remote_frac=0.3)
    seen = []
    name = "drain_strict" if strict else "drain"
    drain = getattr(ex, name)

    def counted(state, ring, *a):
        seen.append(int(ring.valid.sum()))
        return drain(state, ring, *a)

    monkeypatch.setattr(ex, name, counted)
    wps = e.w_per_shard
    remote_lines = sum(int((
        (torch.arange(e.scale.max_lines) < c.neworder.n_lines[..., None])
        & (c.neworder.supply_w // wps != (c.neworder.w // wps)[..., None])
    ).sum()) for c in chunks)
    state = tt.init_state(e.scale, device="cpu")
    for obs in (None, ObsSession(metrics=True, trace=False)):
        seen.clear()
        if strict:
            ex.run_escrow(state, e.init_escrow(state), chunks, obs=obs)
        else:
            ex.run(state, chunks, obs=obs)
        if obs is None:
            assert ex.last_run == {}
    assert ex.last_run["drain_lanes"] == len(chunks) * R * rows * (
        bps * R * e.scale.max_lines)
    live = ex.last_run["drain_live_lanes"]
    assert live == sum(seen)
    if R == 1:
        assert live == remote_lines == 0
    elif strict:
        assert 0 < live < remote_lines   # some orders abort
    else:
        assert live == remote_lines > 0


def _kept_case(regime, R):
    """An executor, its chunks, a state and escrow, and ``call(ex, state,
    esc, chunks, obs=None)`` that runs them and returns (state, escrow,
    counters)."""
    strict = regime == "escrow"
    e = _engine(R, **(dict(STRICT, hot_items=4, admission="kernel")
                      if strict else {}))
    ex = FusedExecutor(e, ring_rows=3)
    chunks = _chunks(e, 7, 3, seed=11, remote_frac=0.3, item_skew=1.2)
    state = tt.init_state(e.scale, device="cpu")
    esc = e.init_escrow(state) if strict else None

    def call(ex, state, esc, chunks, obs=None):
        if strict:
            s, esc, c, *_ = ex.run_escrow(state, esc, chunks, obs=obs)
            return s, esc, c
        s, c, _ = ex.run(state, chunks, obs=obs)
        return s, None, c
    return e, ex, chunks, state, esc, call


def _kept_ptrs(ex):
    _, ring, counters, _ = ex._kept.live
    return [x.data_ptr() for x in (*ring, *counters)]


def _trees_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("regime", ["merge", "escrow"])
def test_second_call_reuses_the_ring_and_counters(regime, R):
    """A second call on the same executor and tables keeps the first
    call's ring and counters (the same addresses), zeroed: it ends where a
    fresh executor's call on a copy of the tables ends, state, escrow and
    counters bit for bit."""
    e, ex, chunks, state, esc, call = _kept_case(regime, R)
    state, esc, first = call(ex, state, esc, chunks)
    assert int(first.neworders.sum()) > 0
    ptrs = _kept_ptrs(ex)
    copy = tt.copy_tree(state), None if esc is None else tt.copy_tree(esc)
    s2, esc2, c2 = call(ex, state, esc, chunks)
    assert _kept_ptrs(ex) == ptrs
    want_s, want_esc, want_c = call(FusedExecutor(e, ring_rows=3), *copy,
                                    chunks)
    assert _trees_equal(s2, want_s) and _trees_equal(c2, want_c)
    if esc is not None:
        assert _trees_equal(esc2, want_esc)


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("regime", ["merge", "escrow"])
def test_returned_counters_outlive_the_next_call(regime, R):
    """A call returns a copy of its counters: the next call's reset and
    its own counts, on the kept buffers, leave the first call's values as
    they were."""
    e, ex, _, state, esc, call = _kept_case(regime, R)
    chunks = _chunks(e, 6, 3, seed=13)                 # two chunks of 3
    state, esc, first = call(ex, state, esc, chunks)
    held = tt.copy_tree(first)
    ptrs = _kept_ptrs(ex)
    assert not set(ptrs) & {x.data_ptr() for x in first}
    # one chunk, its graph recording the stream's rounds: the same key
    one = [chunks[0]._replace(pay_rounds=max(c.pay_rounds for c in chunks))]
    _, _, second = call(ex, state, esc, one)
    assert _kept_ptrs(ex) == ptrs
    assert _trees_equal(first, held)
    assert 2 * int(second.neworders.sum() + second.aborts.sum()) == \
        int(first.neworders.sum() + first.aborts.sum()) > 0


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("regime", ["merge", "escrow"])
def test_new_tables_or_batch_width_get_new_buffers(regime, R):
    """The key sees the tables' addresses and the batch width: a call on
    another state tensor, or at another batch width a shard, gets a new
    ring and new counters, and ends as a fresh executor's call does."""
    e, ex, chunks, state, esc, call = _kept_case(regime, R)
    call(ex, state, esc, chunks)
    old = ex._kept.live
    other = tt.copy_tree(state)
    other_esc = None if esc is None else tt.copy_tree(esc)
    copy = tt.copy_tree(other), None if esc is None else tt.copy_tree(esc)
    s, esc2, c = call(ex, other, other_esc, chunks)
    assert not set(_kept_ptrs(ex)) & {x.data_ptr() for t in old[1:3]
                                      for x in t}
    want = call(FusedExecutor(e, ring_rows=3), *copy, chunks)
    assert _trees_equal(s, want[0]) and _trees_equal(c, want[2])
    if esc is not None:
        assert _trees_equal(esc2, want[1])
    old = ex._kept.live
    wide = _chunks(e, 3, 3, bps=8, seed=12)
    call(ex, other, other_esc, wide)
    ring = ex._kept.live[1]
    assert ring.valid.shape[1] == 8 * R * e.scale.max_lines
    assert not set(_kept_ptrs(ex)) & {x.data_ptr() for t in old[1:3]
                                      for x in t}


@pytest.mark.parametrize("R", [1, 2])
def test_metrics_on_escrow_call_keeps_its_ok_buffer(R):
    """A metrics-on escrow call keeps its commit-mask buffer with the ring:
    a second call with as many chunks reuses it, zeroed, and one with
    another count gets a new one; each call's lattice equals a fresh
    executor's on a copy of the tables."""
    from repro_torch.obs import ObsSession

    e, ex, chunks, state, esc, call = _kept_case("escrow", R)

    def lattice(ex, state, esc, chunks):
        obs = ObsSession(metrics=True, trace=False)
        call(ex, state, esc, chunks, obs)
        return [x for m in obs.device_metrics for x in m]

    # two chunks of the same lengths (3 and 1) and Payment rounds
    rounds = max(c.pay_rounds for c in chunks if c.chunk_len == 3)
    fewer = [chunks[0]._replace(pay_rounds=rounds), chunks[2]]
    oks = []
    for part in (chunks, chunks, fewer):
        copy = tt.copy_tree(state), tt.copy_tree(esc)
        got = lattice(ex, state, esc, part)
        oks.append(ex._kept.oks)
        assert oks[-1].buf.shape[0] == len(part)
        assert _trees_equal(got, lattice(FusedExecutor(e, ring_rows=3),
                                         *copy, part))
    assert oks[1] is oks[0] and oks[2] is not oks[1]


# ---------------------------------------------------------------------------
# run_loop against the reference's runs (last: they wait for its
# subprocesses)
# ---------------------------------------------------------------------------

def _held(data, key, s, esc, ring, lanes_only=False):
    """The fields of state, escrow and ring that differ from the
    reference's run ``key``; ``lanes_only`` compares each owner's ring
    lanes as a sorted list (the other path's lane order)."""
    bad = _mismatches(data, key, s)
    if esc is not None:
        bad += _mismatches(data, f"{key}/esc", esc)
    if ring is not None and not lanes_only:
        bad += _mismatches(data, f"{key}/ring", ring)
    elif ring is not None and _sorted_lanes(
            lambda f: getattr(ring, f).numpy()) != _sorted_lanes(
            lambda f: data[f"{key}/ring/{f}"]):
        bad.append("ring lanes")
    return bad


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("R", SHARDS)
def test_fused_run_loop_matches_reference(ref, R, name):
    """The port's ``run_loop`` (fused, the default) against the
    reference's fused run, and its dispatch run where there is one: state,
    escrow, ring, every MixStats count and the monitor's detections."""
    data, detections = ref[R]
    s, esc, st, ring, det = _port(name, R)
    counts = [getattr(st, k) for k in COUNTS]
    key = f"{name}/fused"
    assert _held(data, key, s, esc, ring) == []
    assert counts == data[f"{key}/counts"].tolist()
    assert det == detections[key]
    assert st.fractures_observed == 0 and st.neworders > 0
    if name.startswith("ring") and R > 1:
        assert st.cold_rejects > 0
    if name == "ring":
        assert det and (R == 1 or ring.valid.any())
    if name not in DISPATCH[R]:
        return
    key = f"{name}/dispatch"
    if name == "ring_overflow" and R == 4:
        # where a ring overflows, the lane order decides which entry is
        # dropped: the reference's fused and dispatch runs end apart, and
        # the port's fused run follows the fused one (above)
        assert _held(data, key, s, esc, ring) != []
        return
    assert _held(data, key, s, esc, ring, lanes_only=R > 1) == []
    assert counts == data[f"{key}/counts"].tolist()
    assert det == detections[key]


@pytest.mark.parametrize("R", SHARDS)
def test_port_dispatch_matches_reference_dispatch(ref, R):
    """``fused=False`` and, at R = 1, ``legacy=True`` against the
    reference's same modes (each dispatch ring in its own lane order)."""
    data, detections = ref[R]
    for name in DISPATCH[R]:
        modes = {"dispatch": dict(fused=False)}
        if R == 1 and name in LEGACY:
            modes["legacy"] = dict(legacy=True)
        for mode, kw in modes.items():
            s, esc, st, ring, det = _port(name, R, **kw)
            key = f"{name}/{mode}"
            assert _held(data, key, s, esc, ring) == [], key
            assert [getattr(st, k) for k in COUNTS] == \
                data[f"{key}/counts"].tolist(), key
            assert det == detections[key], key
