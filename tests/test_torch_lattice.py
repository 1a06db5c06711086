"""The port's lattices (``repro_torch.core.lattice``) against the JAX
package's (``repro.core.lattice``), on the CPU.

Each lattice type is made, driven through its operations with seeded
numpy inputs, and joined on both sides; the registry's bottoms, the
tree-level joins and the lattice laws are checked as
``tests/test_lattice.py`` states them.

Tolerance: exact. Every output is a max, a min, a mask, an integer, a
selection, or a float sum the port takes in replica order, as XLA does.
Dtypes must match, except where the reference declares int64 (stamps,
counts) and narrows it to int32 with x64 off: there the port keeps int64
and the values must match.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import lattice as jlat  # noqa: E402
from repro.txn.store import Table as JTable  # noqa: E402
from repro_torch.convert import tree_from_numpy  # noqa: E402
from repro_torch.core import lattice as lat  # noqa: E402
from repro_torch.core import tree  # noqa: E402

CPU = "cpu"


def _np(x):
    if torch.is_tensor(x):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def assert_same(want, got, tag=""):
    """The reference tree ``want`` and the port tree ``got`` have equal
    leaves, in the same order, value for value and dtype for dtype (int64
    in the port may stand for the reference's x64-off int32)."""
    lw = jax.tree_util.tree_leaves(jax.device_get(want))
    lg = tree.leaves(got)
    assert len(lw) == len(lg), f"{tag}: {len(lw)} vs {len(lg)} leaves"
    for i, (x, y) in enumerate(zip(lw, lg)):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype or (x.dtype == np.int32
                                      and y.dtype == np.int64), \
            f"{tag}[{i}]: {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{tag}[{i}]")


def both(state):
    """A reference lattice state and the same state in the port."""
    return state, tree_from_numpy(jax.device_get(state), CPU)


@pytest.mark.parametrize("name,shape,dt", [
    ("max", (3,), "int32"), ("max", (2, 2), "float32"),
    ("min", (3,), "int32"), ("min", (), "float32"),
    ("or", (4,), "bool"), ("and", (4,), "bool"), ("sum", (3,), "float32")])
def test_registry_bottoms(name, shape, dt):
    want = jlat.get_bottom(name)(shape, getattr(jnp, dt))
    got = lat.get_bottom(name)(shape, getattr(torch, dt), device=CPU)
    assert_same(want, got, name)
    x = np.random.default_rng(0).integers(-5, 5, shape).astype(dt)
    assert_same(jlat.get_join(name)(jnp.asarray(x), want),
                lat.get_join(name)(torch.tensor(x), got), f"{name} join")


def test_registry_names_and_errors():
    assert set(lat._JOINS) == set(jlat._JOINS)
    assert lat.get_join("escrow_hot") is lat.HotSetEscrow.join
    with pytest.raises(KeyError, match="unknown lattice"):
        lat.get_join("nope")
    with pytest.raises(ValueError, match="already registered"):
        lat.register_lattice("max", lat.max_join, lat.get_bottom("max"))
    assert_same(jlat.get_bottom("versioned")(4, 2),
                lat.get_bottom("versioned")(4, 2, device=CPU), "versioned")


def _drive_counters(seed, jc, tc, n=12, R=3):
    """Seeded increments (and decrements for a PNCounter) on both sides."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        r, amt = int(rng.integers(0, R)), float(rng.uniform(0, 50))
        op = "decrement" if hasattr(jc, "neg") and rng.random() < 0.4 \
            else "increment"
        jc, tc = getattr(jc, op)(r, amt), getattr(tc, op)(r, amt)
    return jc, tc


@pytest.mark.parametrize("cls", ["GCounter", "PNCounter"])
def test_counters_match_reference(cls):
    ja, ta = _drive_counters(1, getattr(jlat, cls).make(3),
                             getattr(lat, cls).make(3, device=CPU))
    jb, tb = _drive_counters(2, getattr(jlat, cls).make(3),
                             getattr(lat, cls).make(3, device=CPU))
    assert_same(ja, ta, "a")
    assert_same(ja.value(), ta.value(), "value")
    jm, tm = getattr(jlat, cls).join(ja, jb), getattr(lat, cls).join(ta, tb)
    assert_same(jm, tm, "join")
    assert_same(jm.value(), tm.value(), "merged value")


def test_counter_and_histogram_lattices_match_reference():
    rng = np.random.default_rng(3)
    jc, tc = jlat.CounterLattice.make(3, (10,)), lat.CounterLattice.make(
        3, (10,), device=CPU)
    jh, th = jlat.HistogramLattice.make(3, 8), lat.HistogramLattice.make(
        3, 8, device=CPU)
    for r in range(3):
        idx = rng.integers(0, 10, 20)               # duplicates accumulate
        vals = rng.exponential(20.0, 30).astype(np.float32)
        w = (rng.random(30) < 0.8).astype(np.int32)
        jc, tc = jc.bump(r, jnp.asarray(idx), 2), tc.bump(r, idx, 2)
        jc, tc = jc.bump(r), tc.bump(r)
        jh = jh.observe(r, jnp.asarray(vals), jnp.asarray(w))
        th = th.observe(r, torch.tensor(vals), torch.tensor(w))
        assert_same(jh.bin_of(jnp.asarray(vals)),
                    th.bin_of(torch.tensor(vals)), "bin_of")
    assert_same((jc, jc.value(), jh, jh.value()),
                (tc, tc.value(), th, th.value()), "observed")
    jc2, tc2 = both(jlat.CounterLattice(jnp.asarray(
        rng.integers(0, 9, (3, 10)).astype(np.int32))))
    assert_same(jlat.CounterLattice.join(jc, jc2),
                lat.CounterLattice.join(tc, tc2), "counter join")
    jh2 = jh._replace(counts=jnp.asarray(
        rng.integers(0, 9, (3, 8)).astype(np.int32)))
    th2 = tree_from_numpy(jax.device_get(jh2), CPU)
    assert_same(jlat.HistogramLattice.join(jh, jh2),
                lat.HistogramLattice.join(th, th2), "histogram join")
    for n, lo, base in ((16, 1.0, 2.0), (8, 0.5, 4.0), (6, 1.0, 10.0)):
        assert_same(jlat.log_bin_edges(n, lo, base),
                    lat.log_bin_edges(n, lo, base, device=CPU), "edges")


def test_lww_register_matches_reference():
    rng = np.random.default_rng(4)
    regs = []
    for side in range(2):
        j = jlat.LWWRegister.make(100.0, ts=0, replica=side)
        t = lat.LWWRegister.make(100.0, ts=0, replica=side, device=CPU)
        for _ in range(6):
            v, ts, r = (float(rng.uniform(0, 100)), int(rng.integers(0, 5)),
                        int(rng.integers(0, 3)))
            j, t = j.write(v, ts, r), t.write(v, ts, r)
        assert_same(j, t, f"side {side}")
        regs.append((j, t))
    (ja, ta), (jb, tb) = regs
    assert_same(jlat.LWWRegister.join(ja, jb), lat.LWWRegister.join(ta, tb))
    assert_same(jlat.LWWRegister.join(jb, ja), lat.LWWRegister.join(tb, ta))


def test_two_phase_set_matches_reference():
    rng = np.random.default_rng(5)
    sides = []
    for _ in range(2):
        j, t = jlat.TwoPhaseSet.make(16), lat.TwoPhaseSet.make(16, device=CPU)
        add, rem = rng.integers(0, 16, 6), rng.integers(0, 16, 3)
        j, t = j.add(jnp.asarray(add)), t.add(add)
        j, t = j.remove(jnp.asarray(rem)), t.remove(rem)
        j, t = j.add(int(add[0])), t.add(int(add[0]))
        assert_same((j, j.members()), (t, t.members()))
        sides.append((j, t))
    (ja, ta), (jb, tb) = sides
    m = lat.TwoPhaseSet.join(ta, tb)
    assert_same(jlat.TwoPhaseSet.join(ja, jb), m)
    assert_same(jlat.TwoPhaseSet.join(ja, jb).members(), m.members())


def test_escrow_counter_matches_reference():
    rng = np.random.default_rng(6)
    j = jlat.EscrowCounter.make(3, budget=100.0, floor=7.0)
    t = lat.EscrowCounter.make(3, budget=100.0, floor=7.0, device=CPU)
    assert_same(j, t, "make")
    oks = []
    for _ in range(10):
        r, amt = int(rng.integers(0, 3)), float(rng.uniform(0, 25))
        (j, jok), (t, tok) = j.try_spend(r, amt), t.try_spend(r, amt)
        assert bool(jok) == bool(tok)
        oks.append(bool(tok))
        assert_same(j, t, "spend")
    assert any(oks) and not all(oks)
    assert_same(j.remaining(), t.remaining(), "remaining")
    assert_same(j.refresh(), t.refresh(), "refresh")
    alive = np.array([True, False, True])
    assert_same(j.refresh(alive=jnp.asarray(alive)), t.refresh(alive=alive),
                "refresh(alive)")
    jb, tb = both(jlat.EscrowCounter(
        jnp.asarray(rng.uniform(0, 40, 3).astype(np.float32)),
        jnp.asarray(rng.uniform(0, 30, 3).astype(np.float32))))
    assert_same(jlat.EscrowCounter.join(j, jb), lat.EscrowCounter.join(t, tb))


def test_versioned_slots_match_reference():
    rng = np.random.default_rng(7)
    sides = []
    for side in range(2):
        j = jlat.VersionedSlots.make(8, 3)
        t = lat.VersionedSlots.make(8, 3, device=CPU)
        for _ in range(10):
            i, k = int(rng.integers(0, 8)), int(rng.integers(0, 6))
            row = rng.normal(0, 2, 3).astype(np.float32)
            j = j.upsert(i, k * 2 + side, jnp.asarray(row))
            t = t.upsert(i, k * 2 + side, torch.tensor(row))
        assert_same(j, t, f"upsert side {side}")
        assert t.version.dtype == torch.int64
        sides.append((j, t))
    (ja, ta), (jb, tb) = sides
    assert_same(jlat.VersionedSlots.join(ja, jb),
                lat.VersionedSlots.join(ta, tb), "join")
    assert_same(jlat.VersionedSlots.join(jb, ja),
                lat.VersionedSlots.join(tb, ta), "join, other order")
    # one row at a time, as in the reference (whose batched upsert fails)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        ta.upsert(torch.tensor([0, 1]), 9, torch.zeros(2, 3))


def test_lease_lattice_and_stamps_match_reference():
    ja, ta = jlat.LeaseLattice.make(3), lat.LeaseLattice.make(3)
    for r, e, s in ((0, 1, 5), (1, 2, 1), (0, 1, 3), (2, 0, 9)):
        ja, ta = ja.beat(r, e, s), ta.beat(r, e, s)
    jb, tb = jlat.LeaseLattice.make(3).beat(1, 3, 0), \
        lat.LeaseLattice.make(3).beat(1, 3, 0)
    np.testing.assert_array_equal(jlat.LeaseLattice.join(ja, jb).stamps,
                                  lat.LeaseLattice.join(ta, tb).stamps)
    stamp = lat.pack_lease_stamp(7, 2**32 + 5)
    assert int(stamp) == int(jlat.pack_lease_stamp(7, 2**32 + 5))
    assert [int(x) for x in lat.unpack_lease_stamp(stamp)] == [7, 5]


def test_hot_set_escrow_join_through_registry():
    rng = np.random.default_rng(8)
    keys = np.array([3, 9, 20], np.int32)
    ja = jlat.HotSetEscrow.make(2, keys, rng.integers(0, 50, 3))
    jb = ja._replace(spent=jnp.asarray(rng.integers(0, 9, (2, 3)),
                                       jnp.int32))
    (ja, ta), (jb, tb) = both(ja), both(jb)
    assert_same(jlat.get_join("escrow_hot")(ja, jb),
                lat.get_join("escrow_hot")(ta, tb))


def _mixed(step, metrics, mask):
    return {"step": jnp.asarray(step),
            "metrics": jlat.GCounter(jnp.asarray(metrics, jnp.float32)),
            "mask": jnp.asarray(mask)}


def test_tree_join_flat_mixed_state():
    """The reference test's mixed tree: dict keys flatten sorted (mask,
    metrics, step)."""
    ja = _mixed(3, [1.0, 0.0], [True, False])
    jb = _mixed(5, [1.0, 2.0], [False, True])
    names = ("or", "gcounter", "max")
    want = jlat.tree_join_flat(names, ja, jb)
    got = lat.tree_join_flat(names, both(ja)[1], both(jb)[1])
    assert_same(want, got)
    assert bool(got["mask"].all()) and float(got["metrics"].value()) == 3.0
    assert int(got["step"]) == 5
    with pytest.raises(ValueError, match="names for"):
        lat.tree_join_flat(names[:2], both(ja)[1], both(jb)[1])


def test_tree_join_flat_with_a_table_and_tree_join():
    """A Table inside a tree flattens as the reference's pytree: sorted
    columns, then valid, then version, each its own group."""
    rng = np.random.default_rng(9)

    def table():
        return JTable({"y": jnp.asarray(rng.normal(0, 1, 4), jnp.float32),
                       "x": jnp.asarray(rng.integers(0, 9, 4), jnp.int32)},
                      jnp.asarray(rng.random(4) < 0.5),
                      jnp.asarray(rng.integers(0, 9, 4), jnp.int32))

    ja = {"t": table(), "hwm": jnp.asarray(rng.integers(0, 9, 2), jnp.int32)}
    jb = {"t": table(), "hwm": jnp.asarray(rng.integers(0, 9, 2), jnp.int32)}
    names = ("max", "max", "min", "or", "max")   # hwm, t.x, t.y, valid, ver
    want = jlat.tree_join_flat(names, ja, jb)
    got = lat.tree_join_flat(names, both(ja)[1], both(jb)[1])
    assert_same(want, got)
    assert type(got["t"]).__module__ == "repro_torch.txn.store"
    gs = {"hwm": "max", "lww": "lww"}
    ja = {"hwm": ja["hwm"], "lww": jlat.LWWRegister.make(1.0, 4, 1)}
    jb = {"hwm": jb["hwm"], "lww": jlat.LWWRegister.make(2.0, 4, 2)}
    assert_same(jlat.tree_join(gs, ja, jb),
                lat.tree_join(gs, both(ja)[1], both(jb)[1]))


# -- the lattice laws, port side (tests/test_lattice.py's statements) -----

def _floats(n, lo=-100, hi=100):
    return st.lists(st.floats(lo, hi, allow_nan=False, allow_subnormal=False,
                              width=32), min_size=n, max_size=n)


def _bools(n):
    return st.lists(st.booleans(), min_size=n, max_size=n)


def _t(xs, dtype=torch.float32):
    return torch.tensor(np.array(xs), dtype=dtype)


@settings(max_examples=25, deadline=None)
@given(_floats(3), _floats(3), _floats(3), _bools(8), _bools(8), _bools(8))
def test_scalar_join_laws(a, b, c, x, y, z):
    fs = [_t(v) for v in (a, b, c)]
    bs = [_t(v, torch.bool) for v in (x, y, z)]
    lat.check_lattice_laws(lat.max_join, fs)
    lat.check_lattice_laws(lat.min_join, fs)
    lat.check_lattice_laws(lat.or_join, bs)
    lat.check_lattice_laws(lat.and_join, bs)
    assert lat.leaves_equal(lat.or_join(bs[0], torch.zeros(8, dtype=bool)),
                            bs[0])


@settings(max_examples=25, deadline=None)
@given(_floats(3, 0, 50), _floats(3, 0, 50), _floats(3, 0, 50),
       _floats(4, 0, 10), _floats(4, 0, 10), _floats(4, 0, 10))
def test_counter_and_escrow_laws(a, b, c, p, q, r):
    gs = [lat.GCounter(_t(v)) for v in (a, b, c)]
    lat.check_lattice_laws(lat.GCounter.join, gs)
    assert lat.leaves_equal(
        lat.GCounter.join(gs[0], lat.GCounter.make(3, device=CPU)), gs[0])
    es = [lat.EscrowCounter(_t(v[:2]), _t(v[2:])) for v in (p, q, r)]
    lat.check_lattice_laws(lat.EscrowCounter.join, es)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 20), st.integers(0, 3)),
                min_size=3, max_size=3),
       _bools(6), _bools(6), _bools(6), _bools(6))
def test_lww_and_2pset_laws(stamps, a1, a2, r1, r2):
    # (ts, replica) stamps are unique in a real system, so the value is a
    # function of the stamp
    regs = [lat.LWWRegister.make(float(t * 10 + r), t, r, device=CPU)
            for t, r in stamps]
    lat.check_lattice_laws(lat.LWWRegister.join, regs)
    sets = [lat.TwoPhaseSet(_t(x, torch.bool), _t(y, torch.bool))
            for x, y in ((a1, r1), (a2, r2), (a1, r2))]
    lat.check_lattice_laws(lat.TwoPhaseSet.join, sets)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(_bools(4), st.lists(st.integers(-1, 10),
                                               min_size=4, max_size=4),
                          _floats(8, -5, 5)), min_size=3, max_size=3))
def test_versioned_laws(sides):
    # replica-namespaced versions: globally unique stamps, no ties
    slots = [lat.VersionedSlots(_t(v, torch.bool),
                                (_t(ver, torch.int64) + 1) * 4 + r,
                                _t(p).reshape(4, 2))
             for r, (v, ver, p) in enumerate(sides)]
    lat.check_lattice_laws(lat.VersionedSlots.join, slots)


def test_check_lattice_laws_helper():
    samples = [_t([1.0, 2.0]), _t([3.0, 0.0]), _t([2.0, 2.0])]
    lat.check_lattice_laws(lat.max_join, samples)
    with pytest.raises(AssertionError):
        lat.check_lattice_laws(lat.sum_join, samples)
