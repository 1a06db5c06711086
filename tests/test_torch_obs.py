"""The observability plane (``repro_torch.obs``) against the JAX package's
(``repro.obs``).

* The lattices and the recorders, function for function on shared
  numpy-seeded inputs: the lattice laws and the ``ObsMetrics`` join
  (hypothesis where the reference's tests use it), ``record_chunk`` in
  both regimes on the same New-Order batch and commit mask (a lane a
  shard at R > 1: lane r equals the reference's record of block r), the
  proxy bins, ``fold_counters``, ``histogram_quantile`` and the host
  summaries; the item-access record's one-hot and scatter branches agree.
* Metrics are write-only: through ``run_loop`` a metrics-on run ends
  bit-equal to a metrics-off run (state, escrow, retry ring, stats) in the
  merge regime, sparse and dense escrow and with the cold-retry ring.
* ``run_loop(obs=ObsSession(metrics=True, trace=True, ledger=True))``
  snapshots equal the reference's in every exact field (stats, latency
  counts and steps, counters, item access, span counts, the whole ledger)
  at R = 1, 2 and 4; the reference runs in subprocesses on 4 simulated
  devices (``--xla_force_host_platform_device_count=4``), started with the
  module's first test. So do the dispatch path's spans and ledger,
  ``Engine.coordination_ledger`` with the cold-retry ring's drains, and
  ``record_heartbeat_lags``.
* The chunk body under a ``TorchDispatchMode``: with metrics on, the merge
  regime runs the same ops; the escrow regime adds the commit-mask write
  (one ``index_copy_`` a step, one cursor ``add_`` a chunk) and nothing
  else.
* ``python -m repro_torch.launch.tpcc_serve`` on the CPU at tiny sizes,
  and its ``--chaos`` snapshot equal to the reference's
  ``examples/tpcc_serve.py --chaos`` on the same simulator arguments.

Tolerance: exact everywhere, except the fields derived from wall time
(``p50_s``, ``p99_s``, ``step_wall_s``, the span clocks and shares,
``throughput``, ``wall_seconds``), which are checked for presence and
type only.

``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_obs.py``
prints the JAX package's snapshots for ``chip_smoke.py`` phase 20 at full
width (``OBS_REFERENCE`` there), one reference process a row, in turn.
"""

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core import lattice as jlat  # noqa: E402
from repro.obs import ObsSession as JSession  # noqa: E402
from repro.obs import metrics as jobsm  # noqa: E402
from repro.obs.ledger import CoordinationLedger as JLedger  # noqa: E402
from repro.obs.trace import PhaseTracer as JTracer  # noqa: E402
from repro_torch.core import lattice as lat  # noqa: E402
from repro_torch.obs import ObsSession  # noqa: E402
from repro_torch.obs import metrics as obsm  # noqa: E402
from repro_torch.obs.ledger import CoordinationLedger, build_ledger  # noqa: E402
from repro_torch.obs.trace import PhaseTracer  # noqa: E402
from repro_torch.txn import collectives  # noqa: E402
from repro_torch.txn import tpcc as tt  # noqa: E402
from repro_torch.txn.drivers import run_loop  # noqa: E402
from repro_torch.txn.engine import Engine  # noqa: E402
from repro_torch.txn.executor import (FusedExecutor,  # noqa: E402
                                      get_fused_executor, launch_counts)

ROOT = Path(__file__).resolve().parents[1]
SCALE = [8, 4, 8, 64, 64, 15]
RING_SCALE = [4, 2, 8, 32, 512, 15]
MIX = dict(payments=True, reads=True, deliveries=True)
STRICT = dict(stock_invariant="strict")
# name -> (scale, engine knobs, run_loop knobs); sparse_mix's last chunk is
# shorter (two graph lengths share the commit-mask cursor)
CONFIGS = {
    "merge_mix": (SCALE, {}, dict(batch_per_shard=8, n_batches=5,
                                  merge_every=2, remote_frac=0.3, seed=3,
                                  audit=True, **MIX)),
    "sparse_mix": (SCALE, dict(STRICT, hot_items=4, admission="kernel",
                               effects="fused"),
                   dict(batch_per_shard=8, n_batches=6, merge_every=4,
                        refresh_every=2, remote_frac=0.5, seed=5,
                        item_skew=1.2, audit=True, **MIX)),
    "dense_mix": (SCALE, dict(STRICT, escrow_layout="dense"),
                  dict(batch_per_shard=8, n_batches=5, merge_every=2,
                       refresh_every=2, remote_frac=0.3, seed=3, **MIX)),
    "ring": (RING_SCALE, STRICT,
             dict(batch_per_shard=8, n_batches=12, merge_every=4,
                  refresh_every=1, remote_frac=0.6, seed=3, item_skew=1.5,
                  retry_cap=256, retry_max=3, retry_reserve=1)),
}
SHARDS = [1, 2, 4]
# the dispatch path (spans and ledger, no metrics) and the ledgers alone
DISPATCH = dict(CONFIGS["merge_mix"][2], fused=False)
LEDGER_RETRY = dict(chunk_len=4, batch_per_shard=8, payments=False,
                    reads=False)
LEDGER_METRICS = dict(chunk_len=4, batch_per_shard=8, metrics=True)
RETRY_CAP = 16
CHAOS_BATCHES = 9
WALL_FIELDS = ("p50_s", "p99_s")


def exact(snap: dict) -> dict:
    """A snapshot's fields that do not derive from wall time (the same
    function runs in the reference's script)."""
    out = {"schema": snap["schema"]}
    if "stats" in snap:
        out["stats"] = {k: v for k, v in snap["stats"].items()
                        if k not in ("wall_seconds", "throughput")}
    if "latency" in snap:
        out["latency"] = {t: {k: row[k] for k in
                              ("count", "p50_steps", "p99_steps")}
                          for t, row in snap["latency"].items()}
        out["counters"] = snap["counters"]
        out["item_access"] = snap["item_access"]
    if "detection_latency" in snap:
        out["detection_latency"] = snap["detection_latency"]
    out["spans"] = {p: v["count"] for p, v in snap["spans"]["phases"].items()}
    if "ledger" in snap:
        out["ledger"] = snap["ledger"]
    return out


_REFERENCE = r"""
import hashlib, json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.obs import ObsSession
from repro.txn import tpcc
from repro.txn.drivers import run_loop
from repro.txn.engine import Engine
from repro.txn.executor import get_fused_executor

exec(%r)
jobs = json.loads(sys.argv[2])
out = {}
for job in jobs:
    R = job["R"]
    mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
    scale = (tpcc.TPCCScale.spec_scale(job["spec"]) if "spec" in job
             else tpcc.TPCCScale(*job["scale"]))
    e = Engine(scale, mesh, **job["ekw"])
    if job["kind"] == "run":
        state = tpcc.init_state(scale)
        if job.get("stock_multiplier"):
            state = state._replace(
                s_quantity=state.s_quantity * job["stock_multiplier"])
        obs = ObsSession(metrics=job["metrics"], trace=True, ledger=True)
        run_loop(e, e.shard_state(state), obs=obs, **job["kw"])
        out[job["tag"]] = exact(obs.snapshot())
        if job.get("digest"):
            out[job["tag"]]["digest"] = {
                k: hashlib.sha256(np.asarray(x, np.int32).tobytes())
                .hexdigest() for k, x in (
                    ("latency", obs.metrics.latency.counts),
                    ("item_access", obs.metrics.item_access.slots))}
    else:
        led = e.coordination_ledger(**job["kw"])
        rec = {"snapshot": led.snapshot(), "table": led.table()}
        if job.get("retry_cap"):
            bps = job["kw"]["batch_per_shard"]
            ex = get_fused_executor(e, ring_rows=job["kw"]["chunk_len"],
                                    retry_cap=job["retry_cap"])
            for name, st in (("refresh", e.count_refresh_collectives()),
                             ("strict", ex.count_drain_strict_collectives(bps)),
                             ("retry",
                              ex.count_drain_strict_retry_collectives(bps))):
                rec[name] = [dict(st.counts), st.total_bytes()]
        out[job["tag"]] = rec
    print(job["tag"], flush=True)
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def _jobs(R):
    jobs = [dict(kind="run", tag=f"{name}/R{R}", R=R, scale=sc, ekw=ekw,
                 kw=kw, metrics=True)
            for name, (sc, ekw, kw) in CONFIGS.items()]
    if R == 1:
        jobs += [dict(kind="run", tag="dispatch", R=1, scale=SCALE, ekw={},
                      kw=DISPATCH, metrics=False),
                 dict(kind="ledger", tag="ledger_retry", R=1, scale=SCALE,
                      ekw=STRICT, kw=LEDGER_RETRY, retry_cap=RETRY_CAP),
                 dict(kind="ledger", tag="ledger_metrics", R=1, scale=SCALE,
                      ekw=STRICT, kw=LEDGER_METRICS)]
    if R in (1, 4):
        jobs += phase20_jobs((R,), tiny=True)
    return jobs


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
                XLA_FLAGS="--xla_force_host_platform_device_count=4")


def _start(jobs, path, log):
    return subprocess.Popen(
        [sys.executable, "-c", _REFERENCE % inspect.getsource(exact),
         str(path), json.dumps(jobs)], env=_env(), stdout=log,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module", autouse=True)
def _reference_runs(tmp_path_factory):
    """Start the reference's runs (R = 1, 2 and 4) and its chaos demo with
    the module's first test, four subprocesses at once; :func:`ref` waits
    for them."""
    d = tmp_path_factory.mktemp("obs")
    procs = {}
    for R in SHARDS:
        log = open(d / f"R{R}.log", "w")
        procs[f"R{R}"] = (_start(_jobs(R), d / f"R{R}.json", log), log)
    log = open(d / "chaos.log", "w")
    procs["chaos"] = (subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "tpcc_serve.py"), "--chaos",
         "--batches", str(CHAOS_BATCHES), "--json", str(d / "chaos.json")],
        env=_env(), stdout=log, stderr=subprocess.STDOUT, text=True), log)
    yield d, procs
    for p, log in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


@pytest.fixture(scope="module")
def ref(_reference_runs):
    """The reference's results by tag, and its chaos snapshot."""
    d, procs = _reference_runs
    out = {}
    for key, (p, log) in procs.items():
        rc = p.wait(timeout=900)
        log.flush()
        assert rc == 0, (d / f"{key}.log").read_text()[-3000:]
        if key != "chaos":
            out.update(json.loads((d / f"{key}.json").read_text()))
    out["chaos"] = json.loads((d / "chaos.json").read_text())
    return out


def _json(x):
    return json.loads(json.dumps(x))


def _engine(scale, R=1, **kw):
    return Engine(tt.TPCCScale(*scale), device="cpu", n_shards=R, **kw)


# ---------------------------------------------------------------------------
# Lattice laws, against the reference's joins
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


def _tree_eq(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _same(port, ref):
    """Port lattice == reference lattice, leaf by leaf (values and dtype
    width)."""
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               and np.asarray(x).dtype == np.asarray(y).dtype
               for x, y in zip(port, ref))


def _ints(n):
    return st.lists(st.integers(0, 50), min_size=n, max_size=n)


@settings(max_examples=40, deadline=None)
@given(_ints(6), _ints(6), _ints(6))
def test_counter_lattice_laws_match_reference(xs, ys, zs):
    mk = lambda v: np.array(v, np.int32).reshape(3, 2)  # noqa: E731
    port = [lat.CounterLattice(torch.from_numpy(mk(v))) for v in (xs, ys, zs)]
    ref = [jlat.CounterLattice(jnp.asarray(mk(v))) for v in (xs, ys, zs)]
    a, b, c = port
    j = lat.CounterLattice.join
    assert _tree_eq(j(a, b), j(b, a))
    assert _tree_eq(j(a, j(b, c)), j(j(a, b), c))
    assert _tree_eq(j(a, a), a)
    assert _tree_eq(j(a, lat.CounterLattice.make(3, (2,), device="cpu")), a)
    assert _same(j(a, b), jlat.CounterLattice.join(ref[0], ref[1]))


@settings(max_examples=40, deadline=None)
@given(_ints(16), _ints(16), _ints(16))
def test_histogram_lattice_laws_match_reference(xs, ys, zs):
    mk = lambda v: np.array(v, np.int32).reshape(2, 8)  # noqa: E731
    h0 = lat.HistogramLattice.make(2, 8, device="cpu")
    j0 = jlat.HistogramLattice.make(2, 8)
    a, b, c = (h0._replace(counts=torch.from_numpy(mk(v)))
               for v in (xs, ys, zs))
    j = lat.HistogramLattice.join
    assert _tree_eq(j(a, b), j(b, a))
    assert _tree_eq(j(a, j(b, c)), j(j(a, b), c))
    assert _tree_eq(j(a, a), a)
    assert _tree_eq(j(a, h0), a)
    assert _same(j(a, b), jlat.HistogramLattice.join(
        j0._replace(counts=jnp.asarray(mk(xs))),
        j0._replace(counts=jnp.asarray(mk(ys)))))


_values = st.lists(st.floats(0, 1e4, allow_nan=False, allow_subnormal=False,
                             width=32), min_size=1, max_size=12)


def _check_histogram_of_union(xs, ys):
    """join(hist(A), hist(B)) == hist(A ∪ B) on disjoint lanes, and every
    histogram equals the reference's on the same observations."""
    h0 = lat.HistogramLattice.make(2, 8, device="cpu")
    tx, ty = (torch.tensor(v, dtype=torch.float32) for v in (xs, ys))
    a, b = h0.observe(0, tx), h0.observe(1, ty)
    union = h0.observe(0, tx).observe(1, ty)
    merged = lat.HistogramLattice.join(a, b)
    assert _tree_eq(merged, union)
    assert int(merged.value().sum()) == len(xs) + len(ys)
    j0 = jlat.HistogramLattice.make(2, 8)
    jx, jy = (jnp.asarray(np.array(v, np.float32)) for v in (xs, ys))
    assert _same(merged, jlat.HistogramLattice.join(j0.observe(0, jx),
                                                    j0.observe(1, jy)))


@settings(max_examples=40, deadline=None)
@given(_values, _values)
def test_histogram_of_union_property(xs, ys):
    _check_histogram_of_union(xs, ys)


@pytest.mark.parametrize("xs,ys", [([1.0], [1.0]),             # same bin
                                   ([0.0, 3.0, 7.5], [2.0]),   # boundaries
                                   ([1e4] * 5, [0.5, 300.0])])  # open top
def test_histogram_of_union_examples(xs, ys):
    _check_histogram_of_union(xs, ys)


def test_counter_value_reflects_all_replicas():
    c0 = lat.CounterLattice.make(2, (4,), device="cpu")
    a = c0.bump(0, torch.tensor([1, 1, 3]))
    b = c0.bump(1, torch.tensor([0]), amount=5)
    merged = lat.CounterLattice.join(a, b)
    assert merged.value().tolist() == [5, 2, 0, 1]
    j0 = jlat.CounterLattice.make(2, (4,))
    want = jlat.CounterLattice.join(j0.bump(0, jnp.asarray([1, 1, 3])),
                                    j0.bump(1, jnp.asarray([0]), amount=5))
    assert merged.value().tolist() == np.asarray(want.value()).tolist()


def test_registered_joins_pass_lattice_laws():
    counters = [lat.CounterLattice.make(2, device="cpu").bump(0, amount=k)
                for k in (1, 5, 2)]
    lat.check_lattice_laws(lat.CounterLattice.join, counters, eq=_tree_eq)
    hists = [lat.HistogramLattice.make(2, 8, device="cpu").observe(
        0, torch.tensor([v])) for v in (1.0, 7.0, 300.0)]
    lat.check_lattice_laws(lat.HistogramLattice.join, hists, eq=_tree_eq)


def _metrics_sample(seed, R=2, n_items=8):
    """The same random ObsMetrics in both packages."""
    rng = np.random.default_rng(seed)
    lat_c = rng.integers(0, 9, (R, obsm.N_TXN_TYPES, obsm.OBS_BINS),
                         dtype=np.int32)
    ab, cold = (rng.integers(0, 9, (R,), dtype=np.int32) for _ in range(2))
    items = rng.integers(0, 9, (R, n_items), dtype=np.int32)
    m = obsm.make_obs_metrics(R, n_items, device="cpu")
    port = obsm.ObsMetrics(
        m.latency._replace(counts=torch.from_numpy(lat_c)),
        lat.CounterLattice(torch.from_numpy(ab)),
        lat.CounterLattice(torch.from_numpy(cold)),
        lat.CounterLattice(torch.from_numpy(items)))
    j = jobsm.make_obs_metrics(R, n_items)
    ref = jobsm.ObsMetrics(
        j.latency._replace(counts=jnp.asarray(lat_c)),
        jlat.CounterLattice(jnp.asarray(ab)),
        jlat.CounterLattice(jnp.asarray(cold)),
        jlat.CounterLattice(jnp.asarray(items)))
    return port, ref


def _leaves(m):
    return [m.latency.edges, m.latency.counts, m.aborts.slots,
            m.cold_rejects.slots, m.item_access.slots]


def _metrics_equal(port, ref):
    return _same(_leaves(port), _leaves(ref))


def test_obs_metrics_pytree_join_is_lattice():
    samples = [_metrics_sample(s) for s in range(3)]
    port = [p for p, _ in samples]
    lat.check_lattice_laws(obsm.obs_metrics_join, port,
                           eq=lambda a, b: _tree_eq(_leaves(a), _leaves(b)))
    got = obsm.obs_metrics_join(port[0], port[1])
    want = jobsm.obs_metrics_join(samples[0][1], samples[1][1])
    assert _metrics_equal(got, want)
    empty = obsm.make_obs_metrics(3, 16, device="cpu")
    assert _metrics_equal(empty, jobsm.make_obs_metrics(3, 16))


# ---------------------------------------------------------------------------
# Recorders, against the reference's functions
# ---------------------------------------------------------------------------


class _NewOrders:
    """The four fields record_chunk reads, stacked [T, B, ...]."""

    def __init__(self, i_id, n_lines, supply_w, w):
        self.i_id, self.n_lines, self.supply_w, self.w = \
            i_id, n_lines, supply_w, w


def _chunk(T=3, B=4, L=5, n_items=32, seed=0, supply=None):
    """One chunk's New-Order fields as numpy arrays."""
    rng = np.random.default_rng(seed)
    i_id = rng.integers(0, n_items, (T, B, L), dtype=np.int32)
    n_lines = rng.integers(1, L + 1, (T, B), dtype=np.int32)
    w = np.zeros((T, B), np.int32)
    supply_w = rng.integers(0, 2, (T, B, L), dtype=np.int32)
    if supply is not None:
        supply_w = np.full_like(supply_w, supply)
    return i_id, n_lines, supply_w, w


def _both(arrays):
    return (_NewOrders(*(torch.from_numpy(a) for a in arrays)),
            _NewOrders(*(jnp.asarray(a) for a in arrays)))


def _record(arrays, ok, n_items=32):
    """record_chunk on empty lattices in both packages (R = 1)."""
    p_no, j_no = _both(arrays)
    got = obsm.record_chunk(obsm.make_obs_metrics(1, n_items, device="cpu"),
                            p_no, None if ok is None else torch.from_numpy(ok))
    want = jobsm.record_chunk(jobsm.make_obs_metrics(1, n_items), j_no,
                              None if ok is None else jnp.asarray(ok))
    return got, want


def test_record_chunk_totals_merge_regime():
    T, B = 3, 4
    arrays = _chunk(T, B)
    got, want = _record(arrays, None)
    assert _metrics_equal(got, want)
    lat_counts = got.latency.counts[0]
    assert int(lat_counts[obsm.TXN_TYPES.index("neworder")].sum()) == T * B
    assert int(lat_counts.sum()) == T * B
    assert int(got.item_access.value().sum()) == int(arrays[1].sum())


@pytest.mark.parametrize("supply", [0, 1])
def test_record_chunk_latency_proxy_bins(supply):
    """All-local chunk: proxy 1, bin 0; all-remote: 1 + T - t > 1."""
    arrays = _chunk(supply=supply)
    got, want = _record(arrays, None)
    assert _metrics_equal(got, want)
    row = got.latency.counts[0, obsm.TXN_TYPES.index("neworder")]
    if supply == 0:
        assert row[0] == arrays[1].size and row[1:].sum() == 0
    else:
        assert row[0] == 0 and row.sum() == arrays[1].size


def test_record_chunk_commit_mask_weights():
    T, B = 3, 4
    arrays = _chunk(T, B)
    ok = np.random.default_rng(1).integers(0, 2, (T, B)).astype(bool)
    got, want = _record(arrays, ok)
    assert _metrics_equal(got, want)
    assert int(got.latency.counts[0].sum()) == int(ok.sum())
    assert int(got.item_access.value().sum()) == int(arrays[1].sum())


@pytest.mark.parametrize("R", [2, 4])
def test_record_chunk_lane_r_is_block_r(R):
    """At R shards lane r holds what the reference's shard_map records for
    shard r: its lane-0 record of block r of the batch."""
    T, B, n_items = 4, 3 * R, 40
    arrays = _chunk(T, B, n_items=n_items, seed=R)
    ok = np.random.default_rng(R).integers(0, 2, (T, B)).astype(bool)
    p_no, _ = _both(arrays)
    got = obsm.record_chunk(obsm.make_obs_metrics(R, n_items, device="cpu"),
                            p_no, torch.from_numpy(ok))
    per = B // R
    for r in range(R):
        block = [a[:, r * per:(r + 1) * per] for a in arrays]
        _, j_no = _both(block)
        want = jobsm.record_chunk(jobsm.make_obs_metrics(1, n_items), j_no,
                                  jnp.asarray(ok[:, r * per:(r + 1) * per]))
        assert np.array_equal(got.latency.counts[r].numpy(),
                              np.asarray(want.latency.counts[0]))
        assert np.array_equal(got.item_access.slots[r].numpy(),
                              np.asarray(want.item_access.slots[0]))


def test_item_access_one_hot_and_scatter_agree(monkeypatch):
    """The two item-access branches give the same sums; above the one-hot
    limit both packages scatter, with the same result."""
    arrays = _chunk(T=4, B=6, n_items=50, seed=7)
    ok = np.ones((4, 6), bool)
    one_hot, want = _record(arrays, ok, n_items=50)
    monkeypatch.setattr(obsm, "_ONE_HOT_MAX_ELEMS", 0)
    monkeypatch.setattr(jobsm, "_ONE_HOT_MAX_ELEMS", 0)
    scatter, want_scatter = _record(arrays, ok, n_items=50)
    assert torch.equal(one_hot.item_access.slots, scatter.item_access.slots)
    assert _metrics_equal(scatter, want_scatter)
    assert _metrics_equal(one_hot, want)


def test_fold_counters_and_cold_rejects_match_reference():
    R = 2
    m = obsm.make_obs_metrics(R, 8, device="cpu")
    jm = jobsm.make_obs_metrics(1, 8)
    vals = [[5, 2], [3, 1], [2, 0], [1, 4], [7, 3]]
    got = obsm.fold_counters(m, *(torch.tensor(v, dtype=torch.int32)
                                  for v in vals))
    for r in range(R):   # the reference folds each shard's [1] lane
        want = jobsm.fold_counters(jm, *(jnp.asarray([v[r]], jnp.int32)
                                         for v in vals))
        assert np.array_equal(got.latency.counts[r].numpy(),
                              np.asarray(want.latency.counts[0]))
        assert got.aborts.slots[r] == int(want.aborts.slots[0])
    lat_counts = got.latency.counts[0]
    for name, v in (("payment", 5), ("order_status", 3),
                    ("stock_level", 2), ("delivery", 1)):
        row = lat_counts[obsm.TXN_TYPES.index(name)]
        assert row[0] == v and row.sum() == v
    rej = obsm.add_cold_rejects(got, torch.tensor([4, 0], dtype=torch.int32))
    want = jobsm.add_cold_rejects(jobsm.make_obs_metrics(2, 8),
                                  jnp.asarray([4, 0], jnp.int32))
    assert rej.cold_rejects.slots.tolist() == \
        np.asarray(want.cold_rejects.slots).tolist() == [4, 0]


def test_histogram_quantile_upper_edge():
    h = lat.HistogramLattice.make(1, 8, device="cpu")
    jh = jlat.HistogramLattice.make(1, 8)
    counts = np.zeros(8, np.int64)
    counts[0], counts[3] = 10, 1
    assert obsm.histogram_quantile(h.edges, counts, 0.50) == 2.0
    assert obsm.histogram_quantile(h.edges, counts, 0.99) == 16.0
    assert obsm.histogram_quantile(h.edges, np.zeros(8), 0.5) == 0.0
    rng = np.random.default_rng(0)
    for _ in range(20):
        c = rng.integers(0, 5, 8) * (rng.random(8) < 0.5)
        for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
            assert obsm.histogram_quantile(h.edges, c, q) == \
                jobsm.histogram_quantile(jh.edges, c, q)


def test_host_summaries_match_reference():
    port, ref = _metrics_sample(3, R=3, n_items=40)
    host = obsm.metrics_to_host(port)
    assert _metrics_equal(host, ref)
    assert obsm.latency_summary(host) == jobsm.latency_summary(ref)
    assert obsm.latency_summary(host, 0.5) == jobsm.latency_summary(ref, 0.5)
    for k in (3, 10):
        assert obsm.item_access_summary(host, k) == \
            jobsm.item_access_summary(ref, k)


def test_metrics_to_host_is_one_copy(monkeypatch):
    """The host copy is one device-to-host transfer of all five leaves,
    bit for bit (the edges' float bits too)."""
    port, _ = _metrics_sample(5)
    calls = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: calls.append(1)
                        or cpu(self, *a, **k))
    host = obsm.metrics_to_host(port)
    assert len(calls) == 1
    assert all(torch.equal(x, y) and x.dtype == y.dtype
               for x, y in zip(_leaves(host), _leaves(port)))


# ---------------------------------------------------------------------------
# Metrics are write-only: metrics-on == metrics-off through run_loop
# ---------------------------------------------------------------------------


def _port_run(name, R, obs, **extra):
    sc, ekw, kw = CONFIGS[name]
    e = _engine(sc, R, **ekw)
    state = tt.init_state(e.scale, device="cpu")
    return run_loop(e, state, obs=obs, return_retry=True, **kw, **extra)


@pytest.mark.parametrize("R", SHARDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_metrics_on_is_bit_exact(name, R):
    for k in executor_kernels():
        k.launches = 0
    off = _port_run(name, R, None)
    launches_off = launch_counts()
    for k in executor_kernels():
        k.launches = 0
    obs = ObsSession(metrics=True, trace=True, ledger=True)
    on = _port_run(name, R, obs)
    assert launch_counts() == launches_off
    for a, b in zip(off[:2] + off[3:], on[:2] + on[3:]):
        assert (a is None) == (b is None)
        if a is not None:
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    st_off, st_on = off[2], on[2]
    st_off.wall_seconds = st_on.wall_seconds = 0.0
    assert st_off == st_on
    snap = obs.snapshot()
    assert snap["latency"]["neworder"]["count"] == st_on.neworders
    for t, f in (("payment", "payments"), ("order_status", "order_statuses"),
                 ("stock_level", "stock_levels"),
                 ("delivery", "deliveries")):
        assert snap["latency"][t]["count"] == getattr(st_on, f)
    assert sum(snap["counters"]["aborts_per_replica"]) == st_on.aborts
    # the cold-reject counter counts the drains' final rejects; the run's
    # stats add the entries still pending at its end (final_flush)
    pending = int(on[3].valid.sum()) if on[3] is not None else 0
    assert sum(snap["counters"]["cold_rejects_per_replica"]) == \
        st_on.cold_rejects - pending


def executor_kernels():
    from repro_torch.txn.executor import KERNELS
    return KERNELS


# ---------------------------------------------------------------------------
# Snapshots against the reference's
# ---------------------------------------------------------------------------


def _port_snapshot(name, R):
    obs = ObsSession(metrics=True, trace=True, ledger=True)
    _port_run(name, R, obs)
    return obs, _json(exact(obs.snapshot()))


@pytest.mark.parametrize("R", SHARDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_snapshot_matches_reference(name, R, ref):
    obs, got = _port_snapshot(name, R)
    want = ref[f"{name}/R{R}"]
    assert got == want
    assert got["ledger"]["hot_collectives"] == 0
    # the fields derived from wall time: present, and floats
    snap = obs.snapshot()
    assert isinstance(snap["step_wall_s"], float)
    for row in snap["latency"].values():
        assert all(isinstance(row[k], float) for k in WALL_FIELDS)
    for p in snap["spans"]["phases"].values():
        assert all(isinstance(p[k], float) for k in
                   ("total_s", "mean_s", "min_s", "max_s", "share"))
    assert isinstance(snap["stats"]["throughput"], float)
    json.loads(obs.to_json())


def test_dispatch_spans_and_ledger_match_reference(ref):
    """The dispatch path takes spans (the audit's) and the ledger, not
    metrics; the snapshot equals the reference's."""
    e = _engine(SCALE)
    obs = ObsSession(metrics=False, trace=True, ledger=True)
    run_loop(e, tt.init_state(e.scale, device="cpu"), obs=obs, **DISPATCH)
    got = _json(exact(obs.snapshot()))
    assert got == ref["dispatch"]
    assert got["spans"] == {"audit": 1} and "latency" not in got


def test_metrics_require_the_fused_path():
    e = _engine(SCALE)
    state = tt.init_state(e.scale, device="cpu")
    kw = dict(batch_per_shard=4, n_batches=2, merge_every=2)
    for mode in (dict(fused=False), dict(legacy=True)):
        with pytest.raises(ValueError, match="fused executor"):
            run_loop(e, state, obs=ObsSession(metrics=True), **mode, **kw)
    _, _, st = run_loop(e, state, obs=ObsSession(metrics=True), **kw)
    assert st.neworders == 8


# ---------------------------------------------------------------------------
# The coordination ledger
# ---------------------------------------------------------------------------

_CLEAN_HLO = "  %add.1 = f32[8]{0} add(%a.0, %b.0)\n"
_DIRTY_HLO = ("  %ar.1 = f32[128]{0} all-reduce(%x.0), "
              "replica_groups={{0,1}}\n")


def _stats(counts, nbytes):
    from collections import Counter
    return collectives.CollectiveStats(Counter(counts), Counter(nbytes))


def test_ledger_hot_budget():
    """The same phases in both ledgers (the reference's from HLO text, the
    port's from counted calls) give the same snapshot and table."""
    clean, dirty = _stats({}, {}), _stats({"all-reduce": 1},
                                          {"all-reduce": 512})
    led = CoordinationLedger(context="unit", txns_per_chunk=10)
    jled = JLedger(context="unit", txns_per_chunk=10)
    led.add("hot scan", clean, hot=True)
    jled.add("hot scan", _CLEAN_HLO, hot=True)
    led.add("drain", dirty, hot=False, calls_per_chunk=0.5)
    jled.add("drain", _DIRTY_HLO, hot=False, calls_per_chunk=0.5)
    led.assert_budget()
    assert led.hot_collectives() == 0
    assert led.bytes_per_chunk() == 512 * 0.5
    assert led.bytes_per_txn() == 25.6
    assert led.snapshot() == jled.snapshot()
    assert led.table() == jled.table()
    led.add("leaky scan", dirty, hot=True)
    with pytest.raises(AssertionError, match="leaky scan"):
        led.assert_budget()


def test_build_ledger_hot_phases_are_collective_free(ref):
    e = _engine(SCALE, **STRICT)
    led = build_ledger(e, **LEDGER_METRICS)
    assert _json(led.snapshot()) == ref["ledger_metrics"]["snapshot"]
    assert led.table() == ref["ledger_metrics"]["table"]
    phases = {p["phase"]: p for p in led.snapshot()["phases"]}
    assert phases["metrics record"]["hot"]
    assert phases["metrics record"]["collectives"] == {}
    assert phases["metrics counter fold"]["collectives"] == {}
    ex = get_fused_executor(e, ring_rows=4)
    assert "NONE" in ex.prove_megastep_coordination_free(4, 8, metrics=True)


def test_coordination_ledger_with_the_retry_ring(ref):
    """The port's side of the reference's
    test_hot_path_collective_free_with_reclamation_and_retry: the hot
    budget holds, the refresh is the amortized coordination point, and the
    retry drain calls what the strict drain calls."""
    e = _engine(SCALE, **STRICT)
    led = e.coordination_ledger(**LEDGER_RETRY)
    want = ref["ledger_retry"]
    assert led.snapshot()["hot_collectives"] == 0
    assert _json(led.snapshot()) == want["snapshot"]
    ex = get_fused_executor(e, ring_rows=4, retry_cap=RETRY_CAP)
    bps = LEDGER_RETRY["batch_per_shard"]
    got = {"refresh": e.count_refresh_collectives(),
           "strict": ex.count_drain_strict_collectives(bps),
           "retry": ex.count_drain_strict_retry_collectives(bps)}
    assert got["refresh"].total_ops > 0
    assert got["retry"].counts == got["strict"].counts
    for k, s in got.items():
        assert [dict(s.counts), sum(s.bytes.values())] == want[k]


# ---------------------------------------------------------------------------
# The tracer, the liveness hook
# ---------------------------------------------------------------------------


def test_tracer_span_accounting():
    tr, jtr = PhaseTracer(enabled=True), JTracer(enabled=True)
    for t in (tr, jtr):
        for _ in range(3):
            with t.span("megastep"):
                pass
        with t.span("drain"):
            pass
    snap, jsnap = tr.snapshot(), jtr.snapshot()
    assert {k: v["count"] for k, v in snap["phases"].items()} == \
        {k: v["count"] for k, v in jsnap["phases"].items()} == \
        {"megastep": 3, "drain": 1}
    assert sum(p["share"] for p in snap["phases"].values()) == \
        pytest.approx(1.0)
    assert snap["sync"] is False
    assert tr.dashboard().splitlines()[:2] == jtr.dashboard().splitlines()[:2]


def test_tracer_nests_spans(monkeypatch):
    """A span keeps its parent (the span open around it) and its self time
    (its clock less its children's); shares over self time sum to 1; the
    dashboard lists each child indented under its parent."""
    from repro_torch.obs import trace

    clock = iter(float(t) for t in range(100))
    monkeypatch.setattr(trace.time, "perf_counter", lambda: next(clock))
    tr = PhaseTracer(enabled=True)
    for _ in range(2):
        with tr.span("call-setup"):          # 7 s, 3 of them its own
            with tr.span("capture"):         # 3 s, 2 of them its own
                with tr.span("graph-record"):
                    pass
            with tr.span("loop-wait"):
                pass
        with tr.span("megastep"):
            pass
    snap = tr.snapshot()["phases"]
    assert {k: v["parent"] for k, v in snap.items()} == {
        "graph-record": "capture", "capture": "call-setup",
        "loop-wait": "call-setup", "call-setup": None, "megastep": None}
    assert {k: (v["count"], v["total_s"], v["self_s"])
            for k, v in snap.items()} == {
        "graph-record": (2, 2.0, 2.0), "capture": (2, 6.0, 4.0),
        "loop-wait": (2, 2.0, 2.0), "call-setup": (2, 14.0, 6.0),
        "megastep": (2, 2.0, 2.0)}
    assert sum(v["share"] for v in snap.values()) == pytest.approx(1.0)
    assert snap["call-setup"]["share"] == pytest.approx(6 / 16)
    names = [line.split()[0] for line in tr.dashboard().splitlines()[2:]]
    indents = [len(line) - len(line.lstrip())
               for line in tr.dashboard().splitlines()[2:]]
    assert names == ["call-setup", "capture", "graph-record", "loop-wait",
                     "megastep"]
    assert indents == [2, 4, 6, 4, 2]


@pytest.mark.parametrize("name", ["merge_mix", "sparse_mix", "ring"])
def test_cpu_executor_call_opens_only_the_reference_phases(name, ref):
    """On the CPU the executor opens none of its call spans: a call with
    its warm-up opens only the loop's phases, those the JAX package's
    run of the same configuration opens."""
    sc, ekw, kw = CONFIGS[name]
    e = _engine(sc, **ekw)
    ex = get_fused_executor(e, ring_rows=kw["merge_every"],
                            deliveries=kw.get("deliveries", False),
                            retry_cap=kw.get("retry_cap", 0))
    from repro_torch.txn.drivers import generate_mix_batches
    from repro_torch.txn.executor import stack_chunks

    no_b, *rest = generate_mix_batches(
        e, batch_per_shard=kw["batch_per_shard"], n_batches=kw["n_batches"],
        remote_frac=kw["remote_frac"], seed=kw["seed"],
        item_skew=kw.get("item_skew", 0.0))
    if not kw.get("payments"):
        rest = [None] * 3
    chunks = stack_chunks(no_b, *rest, kw["merge_every"])
    state = tt.init_state(e.scale, device="cpu")
    obs = ObsSession(metrics=False, trace=True)
    if ex._escrow:
        ex.run_escrow(state, e.init_escrow(state), chunks, obs=obs)
    else:
        ex.run(state, chunks, obs=obs)
    got = set(obs.tracer.phases)
    assert got and got <= set(ref[f"{name}/R1"]["spans"]) - {"audit"}
    assert all(p.parent is None for p in obs.tracer.phases.values())


def test_tracer_keeps_one_parent_a_phase():
    """A phase opened under another parent than its first raises, before
    its body runs, and leaves the tracer's phases as they were."""
    tr = PhaseTracer(enabled=True)
    with tr.span("call-setup"):
        with tr.span("capture"):
            pass
    ran = []
    with pytest.raises(ValueError, match="'capture' opened under None"):
        with tr.span("capture"):
            ran.append(1)
    assert not ran and not tr._stack
    assert {k: (p.parent, p.count) for k, p in tr.phases.items()} == {
        "capture": ("call-setup", 1), "call-setup": (None, 1)}
    with tr.span("call-setup"), tr.span("capture"):
        pass
    assert tr.phases["capture"].count == 2


def test_tracer_disabled_is_inert():
    tr = PhaseTracer(enabled=False, sync=True)
    with tr.span("megastep"):
        pass
    assert tr.snapshot()["phases"] == {} == \
        JTracer(enabled=False).snapshot()["phases"]
    x = torch.zeros(2)
    assert tr.maybe_sync(x) is x
    # a synced tracer on CPU tensors has no device to wait for
    assert PhaseTracer(sync=True).maybe_sync((x, [x])) == (x, [x])


def test_record_heartbeat_lags_matches_reference():
    sess, jsess = (S(metrics=False, trace=False)
                   for S in (ObsSession, JSession))
    for s in (sess, jsess):
        s.record_heartbeat_lags([3, 3, 4])
        s.record_heartbeat_lags([2])
        s.record_heartbeat_lags([])
    snap, jsnap = sess.snapshot(), jsess.snapshot()
    assert snap["detection_latency"] == jsnap["detection_latency"]
    assert snap["detection_latency"]["count"] == 4
    assert snap["detection_latency"]["p99_windows"] >= 4
    assert _json(snap) == _json(jsnap)
    a, b = (obsm.heartbeat_lag_histogram(v) for v in ([1, 5], [8]))
    ab, ba = lat.HistogramLattice.join(a, b), lat.HistogramLattice.join(b, a)
    assert torch.equal(ab.counts, ba.counts)
    want = jlat.HistogramLattice.join(jobsm.heartbeat_lag_histogram([1, 5]),
                                      jobsm.heartbeat_lag_histogram([8]))
    assert _same(ab, want)
    assert obsm.heartbeat_lag_summary(ab) == jobsm.heartbeat_lag_summary(want)


# ---------------------------------------------------------------------------
# The chunk body's ops with metrics on and off
# ---------------------------------------------------------------------------


class _Ops(TorchDispatchMode):
    """The non-view aten ops of the chunk bodies run under it, each with
    whether it touched the commit-mask buffer or its cursor."""

    def __init__(self, ok_ptrs):
        super().__init__()
        self.ok_ptrs = ok_ptrs
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            flat = [a for a in list(args) + list((kwargs or {}).values())
                    if isinstance(a, torch.Tensor)]
            ok = any(a.untyped_storage().data_ptr() in self.ok_ptrs
                     for a in flat)
            self.ops.append((func.overloadpacket.__name__, ok))
        return func(*args, **(kwargs or {}))


def _chunk_ops(monkeypatch, name, metrics):
    """Every non-view op the run's chunk bodies (warm-up and chunks) ran,
    with metrics on or off."""
    log = []
    body = FusedExecutor._chunk

    def recorded(self, state, ring, counters, esc, chunk, oks=None):
        ptrs = set() if oks is None else {
            oks.buf.untyped_storage().data_ptr(),
            oks.cursor.untyped_storage().data_ptr()}
        with _Ops(ptrs) as mode:
            body(self, state, ring, counters, esc, chunk, oks)
        log.extend(mode.ops)

    monkeypatch.setattr(FusedExecutor, "_chunk", recorded)
    _port_run(name, 2, ObsSession(metrics=metrics, trace=True))
    monkeypatch.undo()
    return log


def test_chunk_ops_merge_regime_are_the_metrics_off_ops(monkeypatch):
    off = _chunk_ops(monkeypatch, "merge_mix", False)
    on = _chunk_ops(monkeypatch, "merge_mix", True)
    assert on == off and len(off) > 100
    assert not any(ok for _, ok in on)


@pytest.mark.parametrize("name", ["sparse_mix", "dense_mix"])
def test_chunk_ops_escrow_add_only_the_commit_mask_write(monkeypatch, name):
    _, _, kw = CONFIGS[name]
    n, every = kw["n_batches"], kw["merge_every"]
    off = _chunk_ops(monkeypatch, name, False)
    on = _chunk_ops(monkeypatch, name, True)
    extra = [op for op, ok in on if ok]
    chunks = -(-n // every) + 1        # the run's chunks and the warm-up's
    assert [(op, ok) for op, ok in on if not ok] == off
    assert sorted(extra) == sorted(["index_copy_"] * (n + 1)
                                   + ["add_"] * chunks)


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("row", ["merge mix", "escrow mix"])
def test_phase20_digest_matches_reference_at_tiny_size(row, R, ref):
    """chip_smoke.py phase 20's comparison (``obs_digest`` with the
    lattice digests) on the CPU at ``TINY20``'s size: the port's run equals
    the reference's."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import lattice_digest, obs_digest

    job = next(j for j in phase20_jobs((R,), tiny=True)
               if j["tag"].startswith(row))
    e = _engine(job["scale"], R, **job["ekw"])
    state = tt.init_state(e.scale, device="cpu")
    if job.get("stock_multiplier"):
        state.s_quantity.mul_(job["stock_multiplier"])
    obs = ObsSession(metrics=True, trace=True, ledger=True)
    run_loop(e, state, obs=obs, **job["kw"])
    got = obs_digest(_json(dict(obs.snapshot(),
                                digest=lattice_digest(obs.metrics))))
    assert got == obs_digest(ref[job["tag"]])


# ---------------------------------------------------------------------------
# The serving driver
# ---------------------------------------------------------------------------


def _serve(args, tmp_path):
    out = tmp_path / "snap.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tpcc_serve", "--device",
         "cpu", "--json", str(out), *args],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout, json.loads(out.read_text())


def test_tpcc_serve_on_the_cpu(tmp_path):
    out, snap = _serve(["--batches", "4", "--batch-per-shard", "8",
                        "--warehouses", "2"], tmp_path)
    for section in ("structural proof", "observability plane",
                    "coordination ledger", "2PC strict audit: audit OK",
                    "consistency criteria: 12/12", "escrow audit: audit OK"):
        assert section in out
    assert snap["schema"] == "repro.obs/1"
    assert snap["ledger"]["hot_collectives"] == 0
    assert snap["latency"]["neworder"]["count"] == \
        snap["stats"]["neworders"] == 32


def test_tpcc_serve_chaos_matches_reference(tmp_path, ref):
    out, snap = _serve(["--chaos", "--batches", str(CHAOS_BATCHES)],
                       tmp_path)
    assert "monitor declared replica 2 dead" in out
    assert snap == ref["chaos"]
    assert snap["detection_latency"]["count"] == 1


# ---------------------------------------------------------------------------
# chip_smoke.py phase 20's reference, at full width
# ---------------------------------------------------------------------------

# phase 20's rows: phase 19's "merge mix" and "escrow mix" (txn_megastep)
PHASE20 = dict(warehouses=64, batch=256, n_batches=32, merge_every=8,
               remote_frac=0.01, seed=0, read_frac=0.25, item_skew=1.2,
               stock_multiplier=20)
TINY20 = dict(scale=[8, 4, 8, 64, 256, 15], batch=16, n_batches=16)
PHASE20_ROWS = {
    "merge mix": {},
    "escrow mix": dict(stock_invariant="strict", admission="kernel",
                       effects="fused"),
}


def phase20_jobs(shards=(1, 4), tiny=False):
    """The reference's runs behind ``chip_smoke.OBS_REFERENCE``: each row
    at R = 1 and 4, with metrics and the ledger; ``tiny``, the same at
    ``TINY20``'s size."""
    p = dict(PHASE20, **(TINY20 if tiny else {}))
    jobs = []
    for R in shards:
        for row, ekw in PHASE20_ROWS.items():
            kw = dict(batch_per_shard=p["batch"] // R,
                      n_batches=p["n_batches"], merge_every=p["merge_every"],
                      remote_frac=p["remote_frac"], seed=p["seed"],
                      read_frac=p["read_frac"], **MIX)
            job = dict(kind="run", tag=f"{row}/R{R}" + "/tiny" * tiny, R=R,
                       ekw=ekw, kw=kw, metrics=True, digest=True)
            if tiny:
                job["scale"] = p["scale"]
            else:
                job["spec"] = p["warehouses"]
            if ekw:
                kw.update(refresh_every=1, item_skew=p["item_skew"])
                job["stock_multiplier"] = p["stock_multiplier"]
            jobs.append(job)
    return jobs


if __name__ == "__main__":
    import tempfile
    out = {}
    sys.path.insert(0, str(ROOT))
    from chip_smoke import obs_digest
    with tempfile.TemporaryDirectory() as d:
        for job in phase20_jobs():   # one process a row: memory
            path = Path(d) / "out.json"
            proc = _start([job], path, subprocess.DEVNULL)
            assert proc.wait() == 0
            out.update(json.loads(path.read_text()))
    print(json.dumps({k: obs_digest(v) for k, v in out.items()}))
