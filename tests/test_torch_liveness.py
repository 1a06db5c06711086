"""Self-detecting liveness against the JAX package's.

* ``LeaseMonitor``: detection within its bound and revival, a straggler
  inside the hysteresis, a polled ``source`` — tick by tick against the
  reference's monitor on the same beats;
* the chaos cases of the reference (``tests/test_liveness.py``) on the
  port's ``EscrowPodSimulator`` with no caller mask: a single kill, a kill
  and a revival that hands the shard back, false suspicion, a straggler
  inside the hysteresis, cascading kills, liveness off against the
  omniscient caller, reservations under a kill. Each asserts what the
  reference asserts and ends where the reference's simulator ends on the
  same seed and schedule: counts, ledger, alive view, owners, lease events
  and a digest of every byte of state, escrow and rings. The reference's
  simulator takes about 100 s for the seven cases on the CPU, so it runs
  in three subprocesses started with the module's first test, beside the
  other tests. The revive-never-oversells hypothesis sweep runs on the
  port;
* ``run_loop(liveness=)``: an always-beating monitor is bit-equal to
  ``alive=None``; a monitor whose source stops one replica's beats from
  window 1 ends as the reference's run, at R = 1 in this process and at
  R = 2 and 4 against the reference run once in a subprocess on 4
  simulated devices (``--xla_force_host_platform_device_count=4``).

Tolerance: exact (integers and bools; ``s_ytd`` adds integers far below
2**24).

``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_liveness.py``
prints the JAX package's counts for ``chip_smoke.py``'s phase 18 (b) at
full width (``LIVE_REFERENCE`` there); ``--chaos CASE ...`` prints the
reference's ``chaos_summary`` of those cases as one JSON line.
"""

import hashlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402

from repro.runtime import failures as jf  # noqa: E402
from repro.runtime.liveness import LeaseMonitor as JMonitor  # noqa: E402
from repro.txn import tpcc as jt  # noqa: E402
from repro.txn.audit import check_cold_ledger as j_check  # noqa: E402
from repro.txn.drivers import run_loop as jrun_loop  # noqa: E402
from repro.txn.engine import single_host_engine as jengine  # noqa: E402
from repro_torch.convert import state_to_numpy  # noqa: E402
from repro_torch.core.lattice import pack_lease_stamp  # noqa: E402
from repro_torch.runtime import failures as tf  # noqa: E402
from repro_torch.runtime.liveness import LeaseMonitor  # noqa: E402
from repro_torch.txn import tpcc as tt  # noqa: E402
from repro_torch.txn.audit import assert_audit, check_cold_ledger  # noqa: E402
from repro_torch.txn.drivers import run_loop  # noqa: E402
from repro_torch.txn.engine import Engine  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # pragma: no cover
    HAVE_HYPOTHESIS = False

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# LeaseMonitor, tick by tick against the reference's
# ---------------------------------------------------------------------------

def _monitors(n, **kw):
    return JMonitor(n, **kw), LeaseMonitor(n, **kw)


def _same_monitors(j, t):
    assert j.window == t.window
    assert np.array_equal(j.alive(), t.alive())
    assert np.array_equal(j.stale, t.stale)
    assert j.detections == t.detections and j.revivals == t.revivals
    assert np.array_equal(j.lease.stamps, t.lease.stamps)


def test_monitor_detects_within_bound_and_revives():
    mons = _monitors(3, expiry=1, hysteresis=1)
    seq = [0, 0, 0]

    def beat_all(except_for=()):
        for r in range(3):
            if r not in except_for:
                seq[r] += 1
                for m in mons:
                    m.beat(r, 0, seq[r])

    def tick():
        alive = [m.tick() for m in mons]
        assert np.array_equal(*alive)
        _same_monitors(*mons)
        return alive[1]

    for _ in range(3):
        beat_all()
        assert tick().all()
    mon = mons[1]
    died_at = mon.window
    while mon.window < died_at + mon.detection_bound:
        beat_all(except_for=(1,))
        alive = tick()
    assert not alive[1] and alive[0] and alive[2]
    assert mon.detection_lags() == [mon.detection_bound]
    beat_all(except_for=(1,))
    tick()
    assert len(mon.detections) == 1
    beat_all()
    assert tick().all()
    assert mon.revivals and mon.revivals[-1][1] == 1


def test_monitor_straggler_survives_hysteresis():
    """A replica silent for <= expiry + hysteresis windows is never
    declared dead."""
    mons = _monitors(2, expiry=1, hysteresis=1)
    seq = 0
    for w in range(12):
        seq += 1
        for m in mons:
            m.beat(0, 0, seq)
            if w % 2 == 0:
                m.beat(1, 0, w + 1)
            assert m.tick().all()
        _same_monitors(*mons)
    assert mons[1].detections == []


@pytest.mark.parametrize("expiry,hysteresis", [(1, 1), (0, 1), (2, 0)])
def test_monitor_source_polled_each_tick(expiry, hysteresis):
    stamps = np.zeros(2, np.int64)
    mons = [M(2, expiry=expiry, hysteresis=hysteresis,
              source=lambda w: stamps) for M in (JMonitor, LeaseMonitor)]
    stamps[:] = [int(pack_lease_stamp(0, 1))] * 2
    assert all(m.tick().all() for m in mons)
    bound = mons[1].detection_bound
    for w in range(2, 2 + bound):
        stamps[0] = int(pack_lease_stamp(0, w))
        alive = [m.tick() for m in mons]
        _same_monitors(*mons)
    assert alive[1][0] and not alive[1][1]
    assert mons[1].detection_lags() == [bound]


# ---------------------------------------------------------------------------
# the chaos cases on the simulator, no caller mask
# ---------------------------------------------------------------------------

CHAOS_SCALE = (4, 2, 8, 32, 1024, 15)


def chaos_sim(pkg, **kw):
    """The reference's ``_chaos_sim`` in ``pkg`` ("jax" or "torch")."""
    defaults = dict(retry_cap=128, retry_max=3, seed=11, stock_scale=20,
                    liveness=True)
    defaults.update(kw)
    if pkg == "jax":
        return jf.EscrowPodSimulator(jt.TPCCScale(*CHAOS_SCALE), 4,
                                     **defaults)
    return tf.EscrowPodSimulator(tt.TPCCScale(*CHAOS_SCALE), 4,
                                 device="cpu", **defaults)


def _window(sim, batch=12):
    sim.step(batch)
    sim.drain()
    sim.refresh()


def _stock_nonnegative(sim) -> bool:
    return bool((np.asarray(_host_tree(sim.full_state()).s_quantity)
                 >= 0).all())


def _quiesce_and_check(sim):
    sim.quiesce()
    led = sim.cold_ledger()
    check = check_cold_ledger if isinstance(
        sim, tf.EscrowPodSimulator) else j_check
    check(led, quiescent=True)
    sim.refresh()
    sim.audit()
    return led


def single_kill(pkg):
    sim = chaos_sim(pkg)
    _window(sim)
    committed_before = sim.committed
    sim.kill(1)
    windows_to_detect = 0
    while sim.alive[1]:
        _window(sim)
        windows_to_detect += 1
        assert windows_to_detect <= sim.monitor.detection_bound
    assert sim.monitor.detection_lags() == [sim.monitor.detection_bound]
    assert sim.owner_of[1] == 2
    queued_at_dead = len(sim.pending[1])
    _window(sim)
    assert sim.committed > committed_before
    assert len(sim.pending[1]) == 0 or queued_at_dead == 0
    assert _quiesce_and_check(sim)["queued"] == 0
    return sim


def kill_then_revive(pkg):
    sim = chaos_sim(pkg)
    _window(sim)
    sim.kill(3)
    for _ in range(sim.monitor.detection_bound + 1):
        _window(sim)
    assert not sim.alive[3] and sim.owner_of[3] == 0  # ring wraps 3 -> 0
    sim.revive(3)
    for _ in range(2):
        _window(sim)
    assert sim.alive[3] and sim.owner_of[3] == 3
    assert sim.epoch[3] == 1
    _quiesce_and_check(sim)
    return sim


def false_suspicion(pkg):
    sim = chaos_sim(pkg)
    _window(sim)
    long_stall = sim.monitor.detection_bound + 2
    sim.stall(0, long_stall)
    saw_suspected = False
    for _ in range(long_stall + 2):
        _window(sim)
        if not sim.alive[0]:
            saw_suspected = True
            assert sim.owner_of[0] == 1
    assert saw_suspected
    for _ in range(2):
        _window(sim)
    assert sim.alive[0] and sim.owner_of[0] == 0
    assert sim.monitor.revivals
    _quiesce_and_check(sim)
    return sim


def straggler_inside_hysteresis(pkg):
    sim = chaos_sim(pkg)
    _window(sim)
    stall = sim.lease_expiry + sim.lease_hysteresis
    sim.stall(2, stall)
    for _ in range(stall + 1):
        _window(sim)
        assert sim.alive[2]
    assert sim.monitor.detections == []
    _quiesce_and_check(sim)
    return sim


def cascading_kills(pkg):
    sim = chaos_sim(pkg)
    _window(sim)
    sim.kill(0)
    for _ in range(sim.monitor.detection_bound):
        _window(sim)
    sim.kill(1)
    sim.kill(3)
    for _ in range(sim.monitor.detection_bound + 1):
        _window(sim)
    assert sim.alive == [False, False, True, False]
    assert sim.owner_of == [2, 2, 2, 2]
    _window(sim)
    assert _quiesce_and_check(sim)["queued"] == 0
    return sim


def liveness_off_is_legacy(pkg):
    def run(liveness):
        sim = chaos_sim(pkg, retry_cap=64, retry_max=2, seed=5,
                        stock_scale=10, liveness=liveness)
        for _ in range(2):
            _window(sim, batch=8)
        return sim
    legacy, lease = run(False), run(True)
    assert _digest(legacy) == _digest(lease)
    assert legacy.cold_ledger() == lease.cold_ledger()
    return lease


def reservations_under_a_kill(pkg):
    sim = chaos_sim(pkg, reserve=True, stock_scale=2, seed=3)
    sim.kill(2)
    for _ in range(5):
        _window(sim, batch=16)
        assert _stock_nonnegative(sim)
        led = sim.cold_ledger()
        assert led["exact"] and led["reservations_exact"], led
    sim.revive(2)
    for _ in range(2):
        _window(sim, batch=16)
    led = _quiesce_and_check(sim)
    assert led["res_granted"] == led["res_completed"]
    return sim


CHAOS = {f.__name__: f for f in (
    single_kill, kill_then_revive, false_suspicion,
    straggler_inside_hysteresis, cascading_kills, liveness_off_is_legacy,
    reservations_under_a_kill)}


def _host_tree(tree):
    if torch.is_tensor(tree[0]):
        return state_to_numpy(tree)
    return type(tree)(*(np.asarray(x) for x in jax.device_get(tree)))


def _digest(sim) -> str:
    """sha256 of every byte of the state, escrow and rings."""
    h = hashlib.sha256()
    for tree in (sim.full_state(), sim.esc, *sim.rings):
        for x in _host_tree(tree):
            h.update(str(x.dtype).encode() + np.ascontiguousarray(x).tobytes())
    return h.hexdigest()[:16]


def chaos_summary(sim) -> dict:
    return {"committed": sim.committed, "ledger": sim.cold_ledger(),
            "alive": list(sim.alive), "owner_of": list(sim.owner_of),
            "epoch": list(sim.epoch),
            "detections": [list(d) for d in sim.monitor.detections],
            "revivals": [list(r) for r in sim.monitor.revivals],
            "digest": _digest(sim)}


if HAVE_HYPOTHESIS:

    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(0, 2 ** 16),
           kills=st.lists(st.tuples(st.integers(0, 3), st.integers(1, 4),
                                    st.integers(1, 5)),
                          min_size=1, max_size=3, unique_by=lambda t: t[0]))
    def test_revive_never_oversells_sweep(seed, kills):
        """Random kill/revive schedules, lease detection only: stock stays
        nonnegative at every window, the ledgers stay exact, and the
        quiescent audit passes."""
        sim = chaos_sim("torch", reserve=True, seed=seed, stock_scale=4)
        schedule = {}
        for replica, at, dur in kills:
            schedule[at] = schedule.get(at, []) + [(replica, dur)]
        revive_at = {}
        for w in range(10):
            for replica, dur in schedule.get(w, []):
                sim.kill(replica)
                revive_at.setdefault(w + dur, []).append(replica)
            for replica in revive_at.get(w, []):
                sim.revive(replica)
            _window(sim, batch=8)
            assert _stock_nonnegative(sim)
            led = sim.cold_ledger()
            assert led["exact"] and led["reservations_exact"], led
        for replicas in revive_at.values():
            for replica in replicas:
                if not sim.up[replica]:
                    sim.revive(replica)
        for _ in range(sim.monitor.detection_bound + 1):
            _window(sim, batch=8)
        _quiesce_and_check(sim)


# ---------------------------------------------------------------------------
# run_loop(liveness=)
# ---------------------------------------------------------------------------

SMALL = dict(scale=[4, 2, 8, 32, 512, 15], engine={}, shards=[2, 4],
             kw=dict(batch_per_shard=8, n_batches=16, remote_frac=0.6,
                     merge_every=4, refresh_every=1, seed=3, item_skew=1.5,
                     retry_cap=256, retry_max=3),
             expiry=0, hysteresis=1, stop=1)
# chip_smoke.py's phase 18 (b): phase 17's deployment and its rm3 run
PHASE18 = dict(SMALL, scale="spec_scale(64)", engine=dict(hot_items=1),
               shards=[4],
               kw=dict(batch_per_shard=64, n_batches=32, remote_frac=0.5,
                       merge_every=8, refresh_every=1, seed=0, item_skew=1.2,
                       retry_cap=256, retry_max=3))

def stop_beat(R, dead, stop, pack):
    """A monitor source: every replica beats once a window, but ``dead``'s
    stamp stops advancing at window ``stop`` (the reference's script runs
    this same function)."""
    def source(window):
        seq = np.full(R, window + 1, np.int64)
        seq[dead] = min(window, stop - 1) + 1
        return np.asarray(pack(0, seq), np.int64)
    return source


def dead_replica(R):
    return min(2, R - 1)


def _monitor(M, R, cfg, pack):
    return M(R, expiry=cfg["expiry"], hysteresis=cfg["hysteresis"],
             source=stop_beat(R, dead_replica(R), cfg["stop"], pack))


_REFERENCE = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.lattice import pack_lease_stamp
from repro.runtime.liveness import LeaseMonitor
from repro.txn import tpcc
from repro.txn.audit import assert_audit
from repro.txn.drivers import run_loop
from repro.txn.engine import Engine
""" + inspect.getsource(stop_beat) + r"""
assert len(jax.devices()) == 4, jax.devices()
cfg = json.loads(sys.argv[2])
scale = (tpcc.TPCCScale.spec_scale(64) if cfg["scale"] == "spec_scale(64)"
         else tpcc.TPCCScale(*cfg["scale"]))
COUNTS = ("neworders", "aborts", "cold_rejects", "refreshes",
          "anti_entropy_rounds")
out, summary = {}, {}
for R in cfg["shards"]:
    mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
    e = Engine(scale, mesh, stock_invariant="strict", **cfg["engine"])
    s0 = tpcc.init_state(scale)
    q0 = np.asarray(s0.s_quantity)
    mon = LeaseMonitor(R, expiry=cfg["expiry"], hysteresis=cfg["hysteresis"],
                       source=stop_beat(R, min(2, R - 1), cfg["stop"],
                                        pack_lease_stamp))
    s, esc, st, ring = run_loop(e, e.shard_state(s0), fused=False,
                                return_retry=True, liveness=mon, **cfg["kw"])
    assert_audit(s, escrow=esc, initial_stock=q0, strict_stock=True)
    key = f"R{R}"
    for tag, tree in ((key, s), (f"{key}/esc", esc), (f"{key}/ring", ring)):
        for f, x in zip(tree._fields, jax.device_get(tree)):
            out[f"{tag}/{f}"] = np.asarray(x)
    counts = [getattr(st, k) for k in COUNTS]
    out[f"{key}/counts"] = np.array(counts)
    summary[key] = dict(zip(COUNTS, counts), ring=out[f"{key}/ring/valid"]
                        .sum(1).tolist(), lags=mon.detection_lags(),
                        detections=[list(d) for d in mon.detections],
                        dead_shares=int(np.asarray(esc.shares)[min(2, R - 1)]
                                        .sum()))
if sys.argv[1] != "-":
    np.savez(sys.argv[1], **out)
print(json.dumps(summary))
"""

COUNTS = ("neworders", "aborts", "cold_rejects", "refreshes",
          "anti_entropy_rounds")


def _start(args, log, **env):
    """Start a reference subprocess on the CPU, its output in ``log``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               **env)
    with open(log, "w") as out:
        return subprocess.Popen([sys.executable, *map(str, args)], env=env,
                                stdout=out, stderr=subprocess.STDOUT)


def _finish(proc, log):
    """Wait for a reference subprocess; returns its last line's JSON."""
    rc = proc.wait(timeout=1200)
    text = Path(log).read_text()
    assert rc == 0, text[-3000:]
    return json.loads(text.strip().splitlines()[-1])


def _start_reference(cfg, out, log):
    """The reference's script on 4 simulated CPU devices."""
    return _start(["-c", _REFERENCE, out, json.dumps(cfg)], log,
                  XLA_FLAGS="--xla_force_host_platform_device_count=4")


def reference(cfg, out="-"):
    """Run the reference's script; returns its summary of counts, ring
    lanes, detections and the dead slot's shares per shard count."""
    with tempfile.TemporaryDirectory() as d:
        log = Path(d) / "reference.log"
        return _finish(_start_reference(cfg, out, log), log)


# the chaos cases' reference runs: three subprocesses of about equal length
# (each compiles its own eager primitives, about 20 s of its 50 s)
CHAOS_GROUPS = (("single_kill", "kill_then_revive",
                 "straggler_inside_hysteresis"),
                ("false_suspicion", "cascading_kills"),
                ("liveness_off_is_legacy", "reservations_under_a_kill"))


@pytest.fixture(scope="module", autouse=True)
def references(request, tmp_path_factory):
    """The reference's subprocesses, started with the module's first test
    so that they run beside the in-process tests: the run_loop script on
    SMALL (read by ``ref``) and the chaos cases (read by ``chaos_ref``).
    Only those that a selected test reads are started."""
    wanted = {item.originalname for item in request.session.items
              if item.module is request.module}
    d = tmp_path_factory.mktemp("liveness")
    procs = {}
    if "test_run_loop_stop_beat_matches_reference" in wanted:
        procs["ref"] = (_start_reference(SMALL, d / "reference.npz",
                                         d / "ref.log"), d / "ref.log")
    if "test_chaos_case_ends_as_the_reference" in wanted:
        for i, group in enumerate(CHAOS_GROUPS):
            log = d / f"chaos{i}.log"
            procs[f"chaos{i}"] = (_start([__file__, "--chaos", *group], log),
                                  log)
    yield d, procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ref(references):
    d, procs = references
    summary = _finish(*procs["ref"])
    with np.load(d / "reference.npz") as data:
        return dict(data), summary


@pytest.fixture(scope="module")
def chaos_ref(references):
    """The reference's ``chaos_summary`` of every case."""
    _, procs = references
    out = {}
    for i in range(len(CHAOS_GROUPS)):
        out.update(_finish(*procs[f"chaos{i}"]))
    return out


def _mismatches(ref, tag, port):
    port = state_to_numpy(port)
    return [f for f, y in zip(port._fields, port)
            if ref[f"{tag}/{f}"].dtype != y.dtype
            or not np.array_equal(ref[f"{tag}/{f}"], y)]


def _port_run(R, monitor=None, fleet_alive=True):
    """The port's run of SMALL at R shards, strictly audited; the escrow
    laws only while some replica is alive (a dead fleet holds no
    shares). By dispatch, as the reference's runs here (the fused path
    gathers the ring in another order: tests/test_torch_executor.py)."""
    e = Engine(tt.TPCCScale(*SMALL["scale"]), stock_invariant="strict",
               device="cpu", n_shards=R)
    q0 = tt.init_state(e.scale, device="cpu").s_quantity
    s, esc, stats, ring = run_loop(
        e, tt.init_state(e.scale, device="cpu"), return_retry=True,
        fused=False, liveness=monitor, **SMALL["kw"])
    assert_audit(s, escrow=esc if fleet_alive else None, initial_stock=q0,
                 strict_stock=True)
    return s, esc, stats, ring


def _always_beating(R):
    mon = LeaseMonitor(R)
    seq = {"n": 0}

    def source(window):
        seq["n"] += 1
        return np.asarray([int(pack_lease_stamp(0, seq["n"]))] * R, np.int64)
    mon.source = source
    return mon


@pytest.mark.parametrize("R", [1, 2, 4])
def test_run_loop_always_beating_monitor_is_alive_none(R):
    """A monitor whose source beats every replica is bit-equal to
    ``alive=None``; it was ticked once a drain window."""
    base = _port_run(R)
    mon = _always_beating(R)
    live = _port_run(R, mon)
    windows = SMALL["kw"]["n_batches"] // SMALL["kw"]["merge_every"]
    assert mon.window == windows and mon.detections == []
    for a, b in (base[0], live[0]), (base[1], live[1]), (base[3], live[3]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [getattr(base[2], k) for k in COUNTS] == \
        [getattr(live[2], k) for k in COUNTS]


def test_run_loop_stop_beat_matches_reference_on_one_shard():
    """R = 1 in this process: the lone replica stops beating, the monitor
    declares it dead and the refresh reclaims its whole share, as in the
    reference's run."""
    scale = jt.TPCCScale(*SMALL["scale"])
    je = jengine(scale, stock_invariant="strict")
    jmon = _monitor(JMonitor, 1, SMALL, pack_lease_stamp)
    js, jesc, jst, jring = jrun_loop(
        je, je.shard_state(jt.init_state(scale)), fused=False,
        return_retry=True, liveness=jmon, **SMALL["kw"])
    tmon = _monitor(LeaseMonitor, 1, SMALL, pack_lease_stamp)
    ts, tesc, tst, tring = _port_run(1, tmon, fleet_alive=False)
    ref = {}
    for name, tree in (("s", js), ("e", jesc), ("r", jring)):
        for f, x in zip(tree._fields, jax.device_get(tree)):
            ref[f"{name}/{f}"] = np.asarray(x)
    assert _mismatches(ref, "s", ts) == []
    assert _mismatches(ref, "e", tesc) == []
    assert _mismatches(ref, "r", tring) == []
    assert [getattr(tst, k) for k in COUNTS] == \
        [getattr(jst, k) for k in COUNTS]
    assert tmon.detections == jmon.detections and tmon.detections
    assert int(tesc.shares.sum()) == 0


@pytest.mark.parametrize("R", [2, 4])
def test_run_loop_stop_beat_matches_reference(ref, R):
    """State, escrow, ring lanes, counts and detections equal to the
    reference's; the dead replica's slot holds no shares at the end."""
    data, summary = ref
    mon = _monitor(LeaseMonitor, R, SMALL, pack_lease_stamp)
    s, esc, stats, ring = _port_run(R, mon)
    key = f"R{R}"
    assert _mismatches(data, key, s) == []
    assert _mismatches(data, f"{key}/esc", esc) == []
    assert _mismatches(data, f"{key}/ring", ring) == []
    assert [getattr(stats, k) for k in COUNTS] == \
        data[f"{key}/counts"].tolist()
    assert mon.detection_lags() == summary[key]["lags"]
    assert [list(d) for d in mon.detections] == summary[key]["detections"]
    assert int(esc.shares[dead_replica(R)].sum()) == 0
    # the reclaim changed the run: it is not the alive=None run
    base = _port_run(R)
    assert not torch.equal(base[1].shares, esc.shares)


def test_fused_and_obs_still_raise_naming_their_items():
    """``fused=True`` and ``obs`` are ported: the stop-beat liveness run on
    one shard through the fused executor, with an observability session
    fed the monitor's detection lags (the liveness hook), ends as the
    reference's fused run (state, escrow, ring, counts, detections, the
    session's detection-latency summary and metrics), and as the port's
    dispatch run (spans only: metrics need the fused path)."""
    from repro.obs import ObsSession as JSession
    from repro_torch.obs import ObsSession

    e = Engine(tt.TPCCScale(*SMALL["scale"]), stock_invariant="strict",
               device="cpu")
    scale = jt.TPCCScale(*SMALL["scale"])
    je = jengine(scale, stock_invariant="strict")
    jmon = _monitor(JMonitor, 1, SMALL, pack_lease_stamp)
    jobs = JSession(metrics=True, trace=False)
    js, jesc, jst, jring = jrun_loop(
        je, je.shard_state(jt.init_state(scale)), fused=True,
        return_retry=True, liveness=jmon, obs=jobs, **SMALL["kw"])
    jobs.record_heartbeat_lags(jmon.detection_lags())
    ref = {}
    for name, tree in (("s", js), ("e", jesc), ("r", jring)):
        for f, x in zip(tree._fields, jax.device_get(tree)):
            ref[f"{name}/{f}"] = np.asarray(x)
    runs = []
    for fused in (True, False):
        tmon = _monitor(LeaseMonitor, 1, SMALL, pack_lease_stamp)
        obs = ObsSession(metrics=fused, trace=False)
        ts, tesc, tst, tring = run_loop(
            e, tt.init_state(e.scale, device="cpu"), fused=fused,
            return_retry=True, liveness=tmon, obs=obs, **SMALL["kw"])
        obs.record_heartbeat_lags(tmon.detection_lags())
        assert obs.detection_latency_summary() == \
            jobs.detection_latency_summary()
        if fused:
            steps = lambda lat: {t: (r["count"], r["p50_steps"],  # noqa
                                     r["p99_steps"]) for t, r in lat.items()}
            assert steps(obs.latency_summary()) == \
                steps(jobs.latency_summary())
            assert obs.snapshot()["counters"] == \
                jobs.snapshot()["counters"]
        assert _mismatches(ref, "s", ts) == []
        assert _mismatches(ref, "e", tesc) == []
        assert _mismatches(ref, "r", tring) == []
        assert [getattr(tst, k) for k in COUNTS] == \
            [getattr(jst, k) for k in COUNTS]
        assert tmon.detections == jmon.detections != []
        runs.append(tst)
    assert runs[0].anti_entropy_rounds == tmon.window == \
        SMALL["kw"]["n_batches"] // SMALL["kw"]["merge_every"]


@pytest.mark.parametrize("case", list(CHAOS))
def test_chaos_case_ends_as_the_reference(chaos_ref, case):
    """The port's simulator ends each chaos case where the reference's
    ends on the same seed and schedule (run last: it waits for the
    reference's subprocesses)."""
    assert chaos_summary(CHAOS[case]("torch")) == chaos_ref[case]


if __name__ == "__main__":
    if "--chaos" in sys.argv:
        cases = sys.argv[sys.argv.index("--chaos") + 1:] or list(CHAOS)
        print(json.dumps({k: chaos_summary(CHAOS[k]("jax"))
                          for k in cases}))
    else:
        print(json.dumps(reference(PHASE18), indent=1))
