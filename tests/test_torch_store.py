"""The port's versioned store (``repro_torch.txn.store``) against the JAX
package's (``repro.txn.store``), on the CPU: ``Table`` make, insert
(first writer wins), update (version-gated), delete, count and join, and
``namespaced_version``, on the same seeded operations; the join laws on
the port side.

Tolerance: exact. Stamps compare by value: the port's are int64, the
reference's int32 with x64 off.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side
pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.txn import store as jstore  # noqa: E402
from repro_torch.core import lattice as lat  # noqa: E402
from repro_torch.txn import store  # noqa: E402

from test_torch_lattice import assert_same  # noqa: E402

CPU = "cpu"
SCHEMA = {"x": "float32", "n": "int32", "v": ((3,), "float32")}


def _schema(mod):
    return {k: (s[0], getattr(mod, s[1])) if isinstance(s, tuple)
            else getattr(mod, s) for k, s in SCHEMA.items()}


def _rows(rng, n):
    return {"x": rng.normal(0, 5, n).astype(np.float32),
            "n": rng.integers(0, 99, n).astype(np.int32),
            "v": rng.normal(0, 1, (n, 3)).astype(np.float32)}


def _drive(seed, replica, n_rep=3, cap=16, steps=8):
    """The same seeded inserts, updates and deletes on both packages'
    tables; returns (reference table, port table)."""
    rng = np.random.default_rng(seed)
    jt = jstore.Table.make(cap, _schema(jnp))
    tt = store.Table.make(cap, _schema(torch), device=CPU)
    assert_same(jt, tt, "make")
    for step in range(steps):
        op = ("insert", "update", "delete")[int(rng.integers(0, 3))]
        idx = rng.choice(cap, size=int(rng.integers(1, 5)), replace=False)
        if op == "delete":
            jt, tt = jt.delete(jnp.asarray(idx)), tt.delete(idx)
        else:
            rows = _rows(rng, len(idx))
            ctr = rng.integers(0, 6, len(idx))
            jv = jstore.namespaced_version(jnp.asarray(ctr), replica, n_rep)
            tv = store.namespaced_version(torch.tensor(ctr), replica, n_rep)
            assert_same(jv, tv, "namespaced_version")
            jt = getattr(jt, op)(jnp.asarray(idx),
                                 {k: jnp.asarray(v) for k, v in rows.items()},
                                 jv)
            tt = getattr(tt, op)(torch.tensor(idx),
                                 {k: torch.tensor(v) for k, v in rows.items()},
                                 tv)
        assert_same(jt, tt, f"step {step} {op}")
        assert int(jt.count()) == int(tt.count())
    return jt, tt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_ops_and_join_match_reference(seed):
    ja, ta = _drive(seed, 0)
    jb, tb = _drive(seed + 10, 1)
    assert ta.capacity == ja.capacity == 16
    assert ta.version.dtype == torch.int64
    assert_same(jstore.Table.join(ja, jb), store.Table.join(ta, tb), "join")
    assert_same(jstore.Table.join(jb, ja), store.Table.join(tb, ta),
                "join, other order")


def test_insert_first_writer_wins_and_scalar_version():
    t = store.Table.make(4, {"x": torch.float32}, device=CPU)
    a = t.insert(torch.tensor([0, 1]), {"x": torch.tensor([1.0, 2.0])},
                 store.namespaced_version(torch.tensor([0, 0]), 0, 2))
    a = a.insert(torch.tensor([1, 2]), {"x": torch.tensor([9.0, 3.0])}, 7)
    assert a.columns["x"].tolist() == [1.0, 2.0, 3.0, 0.0]
    assert a.version.tolist() == [0, 7, 7, -1]
    assert store.version_dtype() == torch.int64
    v = store.namespaced_version(2**31, 3, 4)
    assert v.dtype == torch.int64 and int(v) == 2**31 * 4 + 3


def _tables(cap=6):
    return st.tuples(
        st.lists(st.booleans(), min_size=cap, max_size=cap),
        st.lists(st.integers(0, 10), min_size=cap, max_size=cap),
        st.lists(st.integers(-50, 50), min_size=cap, max_size=cap),
    ).map(lambda t: store.Table(
        {"x": torch.tensor(np.array(t[2], np.float32))},
        torch.tensor(t[0]), torch.tensor(np.array(t[1], np.int64))))


@settings(max_examples=25, deadline=None)
@given(_tables(), _tables(), _tables())
def test_table_join_laws(a, b, c):
    # unique stamps across sides: no version ties
    a, b, c = (store.Table(t.columns, t.valid, (t.version + 1) * 4 + r)
               for r, t in enumerate((a, b, c)))
    lat.check_lattice_laws(store.Table.join, [a, b, c])
