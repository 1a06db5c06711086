"""The cold-retry ring against the JAX package's.

An owner's strict drain rejects a remote-cold outbox entry whose cell
lacks stock. With ``retry_cap`` > 0 each owner keeps such entries in a
bounded ring and re-presents them, greedy by age, for up to ``retry_max``
drain windows; ``retry_reserve=1`` grants a last-chance entry a
reservation out of the leftover stock. The port's pieces are held to the
reference's on the same seeded inputs:

* ``tpcc.apply_stock_updates_strict_tiered_retry`` window by window, with
  ties on (cell, tries, qty) across lanes, overflow beyond a small ring,
  ``retry_max`` 0-3 and ``reserve`` 0 and 1, as ints and as 0-d tensors;
* the reference's head-of-line starvation schedule
  (``tests/test_liveness.py``), its hypothesis property and the
  ``reserve=0`` identity, through both packages;
* ``run_loop`` with the ring at R = 1 in this process, and at R = 2 and 4
  against the reference run once in a subprocess on 4 simulated devices
  (``--xla_force_host_platform_device_count=4``), at the reference's
  reclaim-test scale and knobs (``tests/test_failures.py``);
* the refusals (dense layout, merge regime), the drain's collectives and
  ``audit.check_cold_ledger``.

Tolerance: exact, values and dtypes (every quantity here is an integer or
a bool, and ``s_ytd`` adds integers far below 2**24).

``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_retry.py``
prints the JAX package's counts for the full-width deployment of
``chip_smoke.py``'s phase 17 (71 s on 8 CPU cores, 23 GB of host memory
at its peak).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.txn import tpcc as jt  # noqa: E402
from repro.txn.audit import check_cold_ledger as j_check  # noqa: E402
from repro.txn.drivers import run_loop as jrun_loop  # noqa: E402
from repro.txn.engine import single_host_engine as jengine  # noqa: E402
from repro_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.txn import collectives  # noqa: E402
from repro_torch.txn import tpcc as tt  # noqa: E402
from repro_torch.txn.audit import (assert_audit,  # noqa: E402
                                   check_cold_ledger)
from repro_torch.txn.drivers import run_loop  # noqa: E402
from repro_torch.txn.engine import Engine  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # pragma: no cover
    HAVE_HYPOTHESIS = False

ROOT = Path(__file__).resolve().parents[1]
COUNTS = ("neworders", "aborts", "cold_rejects", "refreshes",
          "anti_entropy_rounds")
# the reference's reclaim test (tests/test_failures.py, _RECLAIM_SUBPROC)
SMALL = dict(
    scale=dict(n_warehouses=4, districts=2, customers=8, n_items=32,
               order_capacity=512, max_lines=15),
    engine={}, stock_multiplier=1, shards=[2, 4],
    kw=dict(batch_per_shard=8, n_batches=16, remote_frac=0.6, merge_every=4,
            refresh_every=1, seed=3, item_skew=1.5),
    # the second call of the resume runs the next 8 batches from seed 4
    split=8, resume_seed=4)
# tag -> run_loop knobs; "noflush" is also the first call of "resume"
RUNS = {"none": {},
        "rm0": dict(retry_cap=256, retry_max=0),
        "rm3": dict(retry_cap=256, retry_max=3),
        "reserve": dict(retry_cap=256, retry_max=3, retry_reserve=1),
        "noflush": dict(retry_cap=256, retry_max=3, final_flush=False),
        "alive": dict(retry_cap=256, retry_max=3, alive=[1, 1, 0, 1])}
# chip_smoke.py's phase 17: the deployment at full TPC-C width as 4 shards
PHASE17 = dict(
    scale="spec_scale(64)", engine=dict(hot_items=1), stock_multiplier=1,
    shards=[4],
    kw=dict(batch_per_shard=64, n_batches=32, remote_frac=0.5,
            merge_every=8, refresh_every=1, seed=0, item_skew=1.2),
    split=16, resume_seed=1)

_REFERENCE = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.txn import tpcc
from repro.txn.audit import assert_audit
from repro.txn.drivers import run_loop
from repro.txn.engine import Engine

assert len(jax.devices()) == 4, jax.devices()
cfg, runs = json.loads(sys.argv[2]), json.loads(sys.argv[3])
scale = (tpcc.TPCCScale.spec_scale(64) if cfg["scale"] == "spec_scale(64)"
         else tpcc.TPCCScale(**cfg["scale"]))
COUNTS = ("neworders", "aborts", "cold_rejects", "refreshes",
          "anti_entropy_rounds")
out, summary = {}, {}


def record(key, s, esc, st, ring):
    # keep a run's results on the host: the next run_loop donates them
    for tag, tree in ((key, s), (f"{key}/esc", esc), (f"{key}/ring", ring)):
        if tree is not None:
            for f, x in zip(tree._fields, jax.device_get(tree)):
                out[f"{tag}/{f}"] = np.asarray(x)
    counts = [getattr(st, k) for k in COUNTS]
    out[f"{key}/counts"] = np.array(counts)
    summary[key] = dict(zip(COUNTS, counts))
    if ring is not None:
        summary[key]["ring"] = out[f"{key}/ring/valid"].sum(1).tolist()
        summary[key]["reserved"] = int(out[f"{key}/ring/reserved"].sum())


for R in cfg["shards"]:
    mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
    e = Engine(scale, mesh, stock_invariant="strict", **cfg["engine"])
    s0 = tpcc.init_state(scale)
    s0 = s0._replace(s_quantity=s0.s_quantity * cfg["stock_multiplier"])
    q0 = np.asarray(s0.s_quantity)
    fresh = lambda: e.shard_state(jax.tree.map(jnp.copy, s0))
    for tag, knobs in runs.items():
        if "alive" in knobs and len(knobs["alive"]) != R:
            continue
        knobs = dict(knobs)
        if "alive" in knobs:
            knobs["alive"] = np.asarray(knobs["alive"], np.int32)
        s, esc, st, ring = run_loop(e, fresh(), fused=False,
                                    return_retry=True,
                                    **dict(cfg["kw"], **knobs))
        assert_audit(s, escrow=esc, initial_stock=q0, strict_stock=True)
        record(f"R{R}/{tag}", s, esc, st, ring)
        if tag == "noflush":
            # final_flush=False for `split` batches, then a resume with the
            # returned ring for as many more
            kw = dict(cfg["kw"], n_batches=cfg["split"])
            s, esc, st, ring = run_loop(e, fresh(), fused=False,
                                        return_retry=True, **kw, **knobs)
            record(f"R{R}/split", s, esc, st, ring)
            kw["seed"] = cfg["resume_seed"]
            s, esc, st, ring = run_loop(e, s, esc, fused=False, retry=ring,
                                        return_retry=True, **kw,
                                        **dict(knobs, final_flush=True))
            assert_audit(s, escrow=esc, initial_stock=q0, strict_stock=True)
            record(f"R{R}/resume", s, esc, st, ring)
if sys.argv[1] != "-":
    np.savez(sys.argv[1], **out)
print(json.dumps(summary))
"""


def reference(cfg, runs, out="-"):
    """Run the reference's script on 4 simulated CPU devices; returns its
    summary of counts, rings and reserved lanes per run."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(out), json.dumps(cfg),
         json.dumps(runs)], env=env, capture_output=True, text=True,
        timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's runs on meshes of 2 and 4 simulated devices."""
    path = tmp_path_factory.mktemp("retry") / "reference.npz"
    reference(SMALL, RUNS, path)
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


def _port_engine(R, **kw):
    return Engine(tt.TPCCScale(**SMALL["scale"]), stock_invariant="strict",
                  device="cpu", n_shards=R, **kw)


def _port_run(e, knobs, state=None, esc=None, **over):
    """The port's run of ``knobs`` (a RUNS entry) over SMALL's stream,
    from ``init_state`` or a run's ``state`` and ``esc``, audited against
    the initial stock; returns (state, esc, stats, ring). By dispatch, as
    the reference's runs here (the fused path gathers the ring in another
    order: tests/test_torch_executor.py)."""
    knobs = dict(knobs)
    if "alive" in knobs:
        knobs["alive"] = torch.tensor(knobs["alive"], dtype=torch.int32)
    if state is None:
        state = tt.init_state(e.scale, device="cpu")
    q0 = tt.init_state(e.scale, device="cpu").s_quantity
    out = run_loop(e, state, esc, return_retry=True, fused=False,
                   **dict(SMALL["kw"], **over), **knobs)
    assert_audit(out[0], escrow=out[1], initial_stock=q0, strict_stock=True)
    return out


# ---------------------------------------------------------------------------
# the drain, window by window
# ---------------------------------------------------------------------------

_jdrain = jax.jit(jt.apply_stock_updates_strict_tiered_retry,
                  static_argnames=("n_items", "w_lo"))
DRAIN_SCALE = tt.TPCCScale(n_warehouses=2, districts=2, customers=8,
                           n_items=16, order_capacity=64, max_lines=15)
W_LO = 2                     # the owner holds global warehouses 2 and 3


def _same_ring(jring, tring) -> list[str]:
    want = jax.device_get(jring)
    return [f for f, x, y in zip(tring._fields, want, tring)
            if np.asarray(x).dtype != y.numpy().dtype
            or not np.array_equal(np.asarray(x), y.numpy())]


def _window(rng, n):
    """A seeded drain window of ``n`` entries on 3 cells of each of the
    owner's warehouses (so lanes tie on cell and qty), some invalid, some
    destined to another owner, some hot; small quantities and big ones
    that never fit (the blockers reservations get round)."""
    dst = rng.integers(W_LO - 1, W_LO + 2, n).astype(np.int32)
    iid = rng.integers(0, 3, n).astype(np.int32)
    qty = rng.choice(np.array([1, 2, 12], np.int32), n)
    valid = rng.random(n) < 0.9
    own = valid & (dst >= W_LO) & (dst < W_LO + 2)
    return dst, iid, qty, own


def _cols(entries):
    """Explicit (w, i, qty) entries as a drain window's columns and mask
    (one masked lane when there are none)."""
    n = max(len(entries), 1)
    cols = np.zeros((3, n), np.int32)
    mask = np.zeros(n, bool)
    for j, e in enumerate(entries):
        cols[:, j], mask[j] = e, True
    return cols, mask


def _host(js):
    """A reference state as the port's host numpy arrays."""
    return state_to_numpy(state_from_numpy(jax.device_get(js), "cpu"))


@pytest.mark.parametrize("scalar", ["int", "tensor"])
@pytest.mark.parametrize("reserve", [0, 1])
@pytest.mark.parametrize("retry_max", [0, 1, 2, 3])
def test_drain_matches_reference_window_by_window(retry_max, reserve, scalar):
    """Eight windows of 8 entries through a ring of 6 lanes (overflow),
    stock 0-6 a cell, the same windows in every case: state, every ring
    lane and the final count equal after each window."""
    rng = np.random.default_rng(0)
    hot = np.array([(W_LO + 1) * DRAIN_SCALE.n_items + 2], np.int32)
    js = jt.init_state(jt.TPCCScale(**dataclasses.asdict(DRAIN_SCALE)),
                       seed=1)
    js = js._replace(s_quantity=jnp.asarray(
        rng.integers(0, 7, js.s_quantity.shape).astype(np.int32)))
    ts = state_from_numpy(jax.device_get(js), "cpu")
    jring, tring = jt.empty_retry(6), tt.empty_retry(6, "cpu")
    if scalar == "int":
        t_knobs = dict(retry_max=retry_max, reserve=reserve)
    else:
        t_knobs = dict(retry_max=torch.tensor(retry_max, dtype=torch.int32),
                       reserve=torch.tensor(reserve, dtype=torch.int32))
    finals, occupied, reserved = 0, 0, 0
    for _ in range(8):
        dst, iid, qty, own = _window(rng, 8)
        remote = np.ones_like(own)
        js, jring, jf = _jdrain(
            js, jnp.asarray(hot), jnp.asarray(dst), jnp.asarray(iid),
            jnp.asarray(qty), jnp.asarray(own), jnp.asarray(remote), jring,
            n_items=DRAIN_SCALE.n_items, w_lo=W_LO,
            retry_max=jnp.asarray(retry_max, jnp.int32),
            reserve=jnp.asarray(reserve, jnp.int32))
        ts, tring, tf = tt.apply_stock_updates_strict_tiered_retry(
            ts, torch.from_numpy(hot), torch.from_numpy(dst),
            torch.from_numpy(iid), torch.from_numpy(qty),
            torch.from_numpy(own), torch.from_numpy(remote), tring,
            DRAIN_SCALE.n_items, w_lo=W_LO, **t_knobs)
        assert tf.dtype == torch.int32 and int(tf) == int(jf)
        assert _same_ring(jring, tring) == []
        want, got = _host(js), state_to_numpy(ts)
        assert [f for f, x, y in zip(got._fields, want, got)
                if not np.array_equal(x, y)] == []
        # hot entries apply unconditionally (shares admitted them
        # upstream); every cold cell keeps its floor
        cold_q = ts.s_quantity.reshape(-1).clone()
        cold_q[int(hot[0]) - W_LO * DRAIN_SCALE.n_items] = 0
        assert (cold_q >= 0).all()
        finals += int(tf)
        occupied = max(occupied, int(tring.valid.sum()))
        reserved += int(tring.reserved.sum())
    # the schedule exercises what it is meant to: finals, a full ring, and
    # reservations wherever a ring loser can have a last chance
    assert finals > 0
    assert occupied == (6 if retry_max else 0)
    assert (reserved > 0) == (reserve == 1 and retry_max >= 2)


def test_ring_ties_land_in_the_reference_lanes():
    """Identical lanes (same cell, tries and qty) and a stable sort: the
    ring's survivors compact into the same lanes as the reference's."""
    hot = np.array([0], np.int32)
    scale = jt.TPCCScale(1, 2, 16, 64, 1024, 15)
    js = jt.init_state(scale, seed=0)
    js = js._replace(s_quantity=js.s_quantity.at[0, :4].set(3))
    ts = state_from_numpy(jax.device_get(js), "cpu")
    jring, tring = jt.empty_retry(8), tt.empty_retry(8, "cpu")
    # window 1: four equal lanes on cell 1 and two on cell 2, all rejected
    # (each cell's total exceeds its 3); window 2 re-presents them
    entries = [(0, 1, 2)] * 4 + [(0, 2, 2), (0, 2, 2), (0, 3, 1)]
    for batch in (entries, []):
        cols, mask = _cols(batch)
        n = len(mask)
        js, jring, jf = _jdrain(js, jnp.asarray(hot), *map(
            jnp.asarray, cols), jnp.asarray(mask), jnp.ones(n, bool), jring,
            n_items=64, w_lo=0, retry_max=jnp.asarray(3, jnp.int32),
            reserve=jnp.asarray(0, jnp.int32))
        ts, tring, tf = tt.apply_stock_updates_strict_tiered_retry(
            ts, torch.from_numpy(hot), *map(torch.from_numpy, cols),
            torch.from_numpy(mask), torch.ones(n, dtype=torch.bool), tring,
            64, retry_max=3)
        assert int(tf) == int(jf) and _same_ring(jring, tring) == []
    # greedy by age: one lane of each cell landed, the rest ride the ring
    assert int(tring.valid.sum()) == 4
    assert tring.tries[tring.valid].tolist() == [1, 1, 1, 1]


# ---------------------------------------------------------------------------
# the starvation schedule (tests/test_liveness.py), through both packages
# ---------------------------------------------------------------------------

RES_SCALE = (1, 2, 16, 64, 1024, 15)


class _Jax:
    """The schedule's steps on the reference's state and drain."""

    hot = jnp.asarray([0], jnp.int32)

    def init(self, cell, stock):
        st = jt.init_state(jt.TPCCScale(*RES_SCALE), seed=0)
        return st._replace(s_quantity=st.s_quantity.at[0, cell].set(stock),
                           s_ytd=st.s_ytd.at[0, cell].set(0.0))

    def ring(self):
        return jt.empty_retry(8)

    def window(self, st, ring, cols, mask, reserve, retry_max=3):
        st, ring, f = _jdrain(
            st, self.hot, *map(jnp.asarray, cols), jnp.asarray(mask),
            jnp.ones(len(mask), bool), ring, n_items=RES_SCALE[3], w_lo=0,
            retry_max=jnp.asarray(retry_max, jnp.int32),
            reserve=jnp.asarray(reserve, jnp.int32))
        return st, ring, int(f)

    def sale(self, st, cell, qty):
        return st._replace(s_quantity=st.s_quantity.at[0, cell].add(-qty),
                           s_ytd=st.s_ytd.at[0, cell].add(float(qty)))

    def host(self, st):
        return _host(st)


class _Torch:
    """The same steps on the port's state and drain."""

    hot = torch.tensor([0], dtype=torch.int32)

    def init(self, cell, stock):
        st = tt.init_state(tt.TPCCScale(*RES_SCALE), seed=0, device="cpu")
        st.s_quantity[0, cell] = stock
        st.s_ytd[0, cell] = 0.0
        return st

    def ring(self):
        return tt.empty_retry(8, "cpu")

    def window(self, st, ring, cols, mask, reserve, retry_max=3):
        st, ring, f = tt.apply_stock_updates_strict_tiered_retry(
            st, self.hot, *map(torch.from_numpy, cols),
            torch.from_numpy(mask), torch.ones(len(mask), dtype=torch.bool),
            ring, RES_SCALE[3], retry_max=retry_max, reserve=reserve)
        return st, ring, int(f)

    def sale(self, st, cell, qty):
        st.s_quantity[0, cell] -= qty
        st.s_ytd[0, cell] += float(qty)
        return st

    def host(self, st):
        return state_to_numpy(st)


def _starved_line_outcome(pkg, reserve, *, stock, blocker, victim,
                          local_sale, cell=5):
    """The reference's head-of-line starvation schedule
    (``tests/test_liveness.py::_starved_line_outcome``): an old blocker
    enters the ring, the victim a window later beside a helper blocker,
    the owner's local traffic sells between the victim's last-chance
    window and its final one. Returns (victim applied, finals, end stock,
    the final state on the host)."""
    st, ring, finals = pkg.init(cell, stock), pkg.ring(), 0
    for entries in ([(0, cell, blocker)],
                    [(0, cell, victim), (0, cell, blocker)], [], []):
        st, ring, f = pkg.window(st, ring, *_cols(entries), reserve)
        finals += f
    before = float(pkg.host(st).s_ytd[0, cell])
    if local_sale <= int(pkg.host(st).s_quantity[0, cell]):
        st = pkg.sale(st, cell, local_sale)
    sold_locally = float(pkg.host(st).s_ytd[0, cell]) - before
    for _ in range(4):
        st, ring, f = pkg.window(st, ring, *_cols([]), reserve)
        finals += f
    host = pkg.host(st)
    assert int(np.asarray(ring.valid).sum()) == 0
    return (float(host.s_ytd[0, cell]) - sold_locally, finals,
            int(host.s_quantity[0, cell]), host)


def _both(reserve, **kw):
    """The schedule through both packages: equal outcome and state."""
    j = _starved_line_outcome(_Jax(), reserve, **kw)
    t = _starved_line_outcome(_Torch(), reserve, **kw)
    assert j[:3] == t[:3]
    assert [f for f, x, y in zip(t[3]._fields, j[3], t[3])
            if not np.array_equal(x, y)] == []
    return t[:3]


def test_reservation_rescues_starved_line():
    """Without reservations the victim gets nothing (3 finals: the two
    blockers and the victim); with them it is applied and only the
    blockers are final."""
    kw = dict(stock=10, blocker=100, victim=8, local_sale=3)
    v0, finals0, stock0 = _both(0, **kw)
    v1, finals1, stock1 = _both(1, **kw)
    assert v0 == 0.0 and finals0 == 3
    assert v1 >= 8.0 and finals1 == 2
    assert stock1 == stock0 - 8 + 3


def test_reserve_zero_is_bit_identical_and_never_reserves():
    """``reserve`` as int 0 and as a 0-d tensor: the same state, ring and
    finals, in both packages, and no lane ever reserved."""
    rng = np.random.default_rng(0)
    pkgs = (_Jax(), _Torch())
    states, rings = [], []
    for pkg in pkgs:
        st = pkg.init(5, 7)
        states += [st, st if isinstance(pkg, _Jax) else tt.copy_tree(st)]
        rings += [pkg.ring(), pkg.ring()]
    zero = (0, jnp.asarray(0), 0, torch.tensor(0))
    for _ in range(6):
        cols, mask = _cols([(0, 5, int(rng.integers(1, 9)))
                            for _ in range(3)])
        finals = []
        for k in range(4):
            pkg = pkgs[k // 2]
            states[k], rings[k], f = pkg.window(states[k], rings[k], cols,
                                                mask, zero[k])
            finals.append(f)
            assert not bool(np.asarray(rings[k].reserved).any())
        assert len(set(finals)) == 1
        hosts = [pkgs[k // 2].host(states[k]) for k in range(4)]
        assert all(np.array_equal(x, y) for h in hosts[1:]
                   for x, y in zip(hosts[0], h))
        assert _same_ring(rings[0], rings[2]) == []
        assert _same_ring(rings[1], rings[3]) == []


if HAVE_HYPOTHESIS:

    @settings(max_examples=25, deadline=None)
    @given(stock=st.integers(5, 40), victim=st.integers(2, 10),
           sale_frac=st.floats(0.2, 0.95))
    def test_reservation_rescue_property(stock, victim, sale_frac):
        """The reference's property, through both packages: across the
        starvation regime greedy-by-age alone always final-rejects the
        victim and reservations always admit it."""
        victim = min(victim, stock)
        local_sale = int(sale_frac * stock)
        if stock - local_sale >= victim:      # keep inside the regime
            local_sale = stock - victim + 1
        kw = dict(stock=stock, blocker=10 * stock, victim=victim,
                  local_sale=local_sale)
        v0, f0, _ = _both(0, **kw)
        v1, f1, _ = _both(1, **kw)
        assert v0 == 0.0 and f0 == 3
        assert v1 >= float(victim) and f1 == 2


# ---------------------------------------------------------------------------
# run_loop with the ring
# ---------------------------------------------------------------------------

def test_run_loop_with_the_ring_matches_reference_on_one_shard():
    """R = 1 in this process: every warehouse is local, so the cold tier
    admits on the hot path and the ring stays empty; each run ends as the
    reference's."""
    scale = jt.TPCCScale(**SMALL["scale"])
    je = jengine(scale, stock_invariant="strict")
    te = _port_engine(1)
    for tag in ("rm3", "reserve"):
        js, jesc, jst, jring = jrun_loop(
            je, je.shard_state(jt.init_state(scale)), fused=False,
            return_retry=True, **SMALL["kw"], **RUNS[tag])
        ts, tesc, tst, tring = _port_run(te, RUNS[tag])
        ref = {}
        for name, tree in (("s", js), ("e", jesc), ("r", jring)):
            for f, x in zip(tree._fields, jax.device_get(tree)):
                ref[f"{name}/{f}"] = np.asarray(x)
        assert _mismatches(ref, "s", ts) == []
        assert _mismatches(ref, "e", tesc) == []
        assert _mismatches(ref, "r", tring) == []
        assert _counts(tst) == _counts(jst)
        assert tring.valid.shape == (1, 256) and not tring.valid.any()


@pytest.mark.parametrize("R,tag", [
    (R, tag) for R in (2, 4) for tag in RUNS
    if tag != "alive" or R == 4])      # the reclaim case has four replicas
def test_run_loop_with_the_ring_matches_reference(ref, R, tag):
    """State, escrow, ring lanes and counts equal to the reference's."""
    s, esc, st, ring = _port_run(_port_engine(R), RUNS[tag])
    key = f"R{R}/{tag}"
    assert _mismatches(ref, key, s) == []
    assert _mismatches(ref, f"{key}/esc", esc) == []
    assert _counts(st) == ref[f"{key}/counts"].tolist()
    if tag == "none":
        assert ring is None
        return
    assert _mismatches(ref, f"{key}/ring", ring) == []
    assert ring.valid.shape == (R, RUNS[tag]["retry_cap"])
    base = ref[f"R{R}/none/counts"].tolist()
    if tag == "rm0":
        # a bitwise no-op against no ring
        assert _mismatches(ref, f"R{R}/none", s) == []
        assert _counts(st) == base and not ring.valid.any()
    elif tag in ("rm3", "reserve") and R == 4:
        # the reference's claim at four replicas (at two, both packages
        # end with one more: the entries still pending are flushed)
        assert st.cold_rejects < base[2]
    elif tag == "alive":
        # the dead slot holds zero shares; the rest cover the hot stock
        assert int(esc.shares[2].sum()) == 0
        hot_q = s.s_quantity.reshape(-1)[esc.keys.long()]
        assert torch.equal(esc.shares.sum(0) - esc.spent.sum(0), hot_q)


@pytest.mark.parametrize("R", [2, 4])
def test_noflush_then_resume_matches_reference(ref, R):
    """``final_flush=False`` leaves the pending entries in the returned
    ring; a second call resumes it through ``retry=``."""
    e = _port_engine(R)
    knobs = RUNS["noflush"]
    s, esc, st, ring = _port_run(e, knobs, n_batches=SMALL["split"])
    for tag, tree in (("", s), ("/esc", esc), ("/ring", ring)):
        assert _mismatches(ref, f"R{R}/split{tag}", tree) == []
    assert _counts(st) == ref[f"R{R}/split/counts"].tolist()
    assert ring.valid.any()
    pending = int(ring.valid.sum())
    s, esc, st, ring = _port_run(e, dict(knobs, final_flush=True), s, esc,
                                 n_batches=SMALL["split"],
                                 seed=SMALL["resume_seed"], retry=ring)
    for tag, tree in (("", s), ("/esc", esc), ("/ring", ring)):
        assert _mismatches(ref, f"R{R}/resume{tag}", tree) == []
    assert _counts(st) == ref[f"R{R}/resume/counts"].tolist()
    assert pending > 0


def test_the_ring_refuses_where_the_reference_does():
    """The merge regime refuses a ring (ValueError); the dense layout
    refuses its drain (RuntimeError): it has no cold tier."""
    scale = jt.TPCCScale(**SMALL["scale"])
    kw = dict(SMALL["kw"], n_batches=1, retry_cap=4, retry_max=1)
    cases = (({}, ValueError), (dict(stock_invariant="strict",
                                     escrow_layout="dense"), RuntimeError))
    for engine_kw, exc in cases:
        je = jengine(scale, **engine_kw)
        with pytest.raises(exc):
            jrun_loop(je, je.shard_state(jt.init_state(scale)), fused=False,
                      **kw)
        te = Engine(tt.TPCCScale(**SMALL["scale"]), device="cpu",
                    **engine_kw)
        with pytest.raises(exc):
            run_loop(te, tt.init_state(te.scale, device="cpu"),
                     fused=False, **kw)


@pytest.mark.parametrize("R", [1, 2, 4])
def test_retry_drain_counts_the_same_collectives(R):
    """The ring is owner-local: the retry drain gathers the outbox once,
    exactly as the plain strict drain does, and touches no other
    owner's ring row."""
    e = _port_engine(R)
    state = tt.init_state(e.scale, device="cpu")
    batch = tt.neworder_batch(e, np.random.default_rng(0), 8, 0.6, 0, 1.5)[0]
    _, _, outbox, _, _ = e.neworder_escrow_step(state, e.init_escrow(state),
                                                batch)
    ring = e.init_retry(16)
    with collectives.counted() as plain:
        e.drain_strict(tt.copy_tree(state), outbox)
    with collectives.counted() as retry:
        _, new, finals = e.drain_strict_retry(tt.copy_tree(state), outbox,
                                              ring, 3, 1)
    assert dict(retry.counts) == dict(plain.counts) == {"all-gather": 4}
    assert dict(retry.bytes) == dict(plain.bytes)
    assert finals.shape == (R,) and finals.dtype == torch.int32
    assert new.valid.shape == (R, 16) and not ring.valid.any()


LEDGERS = [
    dict(exact=True, queued=0, in_ring=0),
    dict(exact=True, queued=2, in_ring=1),
    dict(exact=False, queued=0, in_ring=0),
    dict(exact=True, reservations_exact=False, queued=0, in_ring=0),
    dict(exact=True, reservations_exact=True, queued=0, in_ring=0,
         reserved_in_ring=1),
    dict(exact=True, reservations_exact=True, queued=0, in_ring=0,
         reserved_in_ring=0),
]


@pytest.mark.parametrize("quiescent", [False, True])
@pytest.mark.parametrize("ledger", range(len(LEDGERS)))
def test_check_cold_ledger_matches_reference(ledger, quiescent):
    """Passes and raises on the same ledgers as the reference's."""
    def verdict(check):
        try:
            check(LEDGERS[ledger], quiescent=quiescent)
        except AssertionError:
            return "raises"
        return "passes"
    assert verdict(check_cold_ledger) == verdict(j_check)


if __name__ == "__main__":
    # the JAX package's counts for chip_smoke.py's phase 17
    print(json.dumps(reference(PHASE17, RUNS), indent=1))
