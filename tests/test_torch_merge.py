"""The port's anti-entropy merges (``repro_torch.core.merge``) and the plain
version of kernel B4 (``repro_torch.kernels.lattice_merge``) against the
JAX package, on the CPU.

* ``merge_versioned_fused`` against ``repro.core.merge.
  merge_versioned_fused``, which runs the Pallas kernel in interpret mode
  off the TPU, and against ``lattice_merge_kernel`` called directly with
  the reference test's block sizes, on its ``MERGE_CASES`` shapes and
  dtypes; the audit case of ``tests/test_merge_fused.py``; thresholds that
  round in the payload's dtype; NaN payloads;
* stamps above 2**31, which the reference (x64 off) cannot hold: the
  port's fused merge against its join and a numpy oracle;
* ``merge_trees``, ``merge_many`` and ``converged`` on a tree of
  versioned, gcounter, max and or groups, with 1, 2, 3 and 5 replicas.

Tolerance: exact. Every output is a selection, a max, a mask or an OR.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lattice as jlat  # noqa: E402
from repro.core import merge as jmerge  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lattice_merge import lattice_merge_kernel  # noqa: E402
from repro_torch.convert import tree_from_numpy  # noqa: E402
from repro_torch.core import lattice as lat  # noqa: E402
from repro_torch.core import merge  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.lattice_merge import (  # noqa: E402
    lattice_merge_plain, threshold)

from test_torch_lattice import assert_same  # noqa: E402

CPU = "cpu"
BF16 = "bfloat16"

# the reference's sweep (tests/test_kernels.py): R, W, dtype, block_rows
MERGE_CASES = [(64, 4, "float32", 16), (256, 8, "float32", 64),
               (128, 2, BF16, 128), (512, 1, "float32", 256)]


def _pair(R, W, dtype, seed=0, stamps=(-1, 50)):
    """Two seeded versioned tables, as the reference's sweep draws them;
    returns (reference pair, port pair)."""
    rng = np.random.default_rng(seed)
    raw = [(rng.random(R) < 0.7,
            rng.integers(*stamps, R).astype(np.int32),
            rng.normal(0, 3, (R, W)).astype(np.float32)) for _ in range(2)]
    jp = [jlat.VersionedSlots(jnp.asarray(v), jnp.asarray(s),
                              jnp.asarray(p).astype(getattr(jnp, dtype)))
          for v, s, p in raw]
    return jp, [tree_from_numpy(jax.device_get(x), CPU) for x in jp]


@pytest.mark.parametrize("R,W,dtype,block", MERGE_CASES)
def test_fused_merge_matches_pallas_kernel(R, W, dtype, block):
    (ja, jb), (ta, tb) = _pair(R, W, dtype)
    got, viol = merge.merge_versioned_fused(ta, tb, lo=-5.0, hi=5.0)
    assert got.version.dtype == torch.int64
    want, jviol = jmerge.merge_versioned_fused(ja, jb, lo=-5.0, hi=5.0)
    assert_same((want, jviol), (got, viol), "merge_versioned_fused")
    raw = lattice_merge_kernel(ja.valid, ja.version, ja.payload, jb.valid,
                               jb.version, jb.payload, -5.0, 5.0,
                               block_rows=block, interpret=True)
    assert_same(tuple(raw), (*got, viol), "kernel, block rows")
    assert 0 < int(viol.sum()) < R or W == 1
    assert_same(jlat.VersionedSlots.join(ja, jb),
                lat.VersionedSlots.join(ta, tb), "join")


def test_fused_merge_audits_threshold():
    """The reference's audit case (tests/test_merge_fused.py): the merge
    surfaces the one row whose newer payload breaks the threshold."""
    cap, width = 64, 2
    a = jlat.VersionedSlots(jnp.ones(cap, bool), jnp.full((cap,), 4),
                            jnp.full((cap, width), 1.0, jnp.float32))
    hot = jnp.zeros((cap, width), jnp.float32).at[7].set(99.0)
    b = jlat.VersionedSlots(jnp.ones(cap, bool), jnp.full((cap,), 9),
                            jnp.ones((cap, width), jnp.float32) + hot)
    want = jmerge.merge_versioned_fused(a, b, lo=-10.0, hi=10.0)
    ta, tb = (tree_from_numpy(jax.device_get(x), CPU) for x in (a, b))
    merged, viol = merge.merge_versioned_fused(ta, tb, lo=-10.0, hi=10.0)
    assert_same(want, (merged, viol))
    assert bool(viol[7]) and int(viol.sum()) == 1
    assert float(merged.payload[7, 0]) == 100.0


@pytest.mark.parametrize("dtype", ["float32", BF16])
def test_thresholds_round_in_the_payload_dtype(dtype):
    """``hi=0.1`` flags no payload of 0.1 (0.10000000149 in float32,
    0.10009765625 in bfloat16); the next representable value above is
    flagged; a tie keeps ``a``'s row; NaN is never flagged."""
    jd = getattr(jnp, dtype)
    tenth = np.asarray(jnp.asarray(0.1, jd).astype(jnp.float32))
    above = np.asarray(jnp.nextafter(jnp.asarray(0.1, jd),
                                     jnp.asarray(1.0, jd)).astype(
                                         jnp.float32))
    pay = np.array([[tenth], [above], [np.nan], [-1.0], [-1.5]],
                   np.float32)
    R = pay.shape[0]
    a = jlat.VersionedSlots(jnp.ones(R, bool), jnp.zeros(R, jnp.int32),
                            jnp.asarray(pay).astype(jd))
    b = a._replace(payload=jnp.full((R, 1), 7.0, jd),
                   valid=jnp.asarray([True, False, True, False, False]))
    want = jmerge.merge_versioned_fused(a, b, lo=-1.0, hi=0.1)
    ta, tb = (tree_from_numpy(jax.device_get(x), CPU) for x in (a, b))
    got = merge.merge_versioned_fused(ta, tb, lo=-1.0, hi=0.1)
    assert_same(want, got, dtype)
    assert got[1].tolist() == [False, True, False, False, True]
    assert threshold(0.1, getattr(torch, dtype)) == float(tenth)


def test_stamps_above_2_31_join_as_versioned_slots():
    """The port keeps int64 stamps through the fused merge; the reference
    casts to int32 first (``core/merge.py:74``), which truncates these."""
    rng = np.random.default_rng(11)
    R, W = 300, 3
    base = 2**31 + 10
    va, vb = (rng.integers(base - 50, base + 50, R) for _ in range(2))
    vb[:20] = va[:20]                       # ties: a wins
    pa, pb = (rng.normal(0, 1, (R, W)).astype(np.float32) for _ in range(2))
    ma, mb = rng.random(R) < 0.5, rng.random(R) < 0.5
    a = lat.VersionedSlots(torch.tensor(ma), torch.tensor(va),
                           torch.tensor(pa))
    b = lat.VersionedSlots(torch.tensor(mb), torch.tensor(vb),
                           torch.tensor(pb))
    fused, viol = merge.merge_versioned_fused(a, b, lo=-1.0, hi=1.0)
    joined = lat.VersionedSlots.join(a, b)
    newer = vb > va
    oracle = (ma | mb, np.maximum(va, vb), np.where(newer[:, None], pb, pa))
    for x, y, z in zip(fused, joined, oracle):
        assert torch.equal(x, y)
        np.testing.assert_array_equal(x.numpy(), z)
    assert fused.version.dtype == torch.int64
    assert int(fused.version.min()) >= 2**31 - 40
    bad = (oracle[2] < -1.0) | (oracle[2] > 1.0)
    np.testing.assert_array_equal(viol.numpy(), oracle[0] & bad.any(1))


def test_plain_version_types_and_entry():
    """The CPU entry runs the plain version; an int32 payload compares in
    float32 (as JAX with x64 off promotes it); int32 stamps stay int32."""
    rng = np.random.default_rng(12)
    R, W = 40, 2
    side = lambda: (
        torch.tensor(rng.random(R) < 0.5),
        torch.tensor(rng.integers(0, 9, R).astype(np.int32)),
        torch.tensor(rng.integers(-2**25, 2**25, (R, W)).astype(np.int32)))
    args = side() + side()
    got = ops.lattice_merge(*args, lo=-2.0**24, hi=2.0**24 + 1)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32
    jargs = [jnp.asarray(x.numpy()) for x in args]
    assert_same(jref.lattice_merge_ref(*jargs, -2.0**24, 2.0**24 + 1), got)
    for x, y in zip(got, lattice_merge_plain(*args, -2.0**24, 2.0**24 + 1)):
        assert torch.equal(x, y)


def _replica_tree(r, seed, R=48, W=3, n_rep=5, tie=False):
    """Replica ``r`` of a state tree with a versioned table, a gcounter, a
    high-water mark and a seen mask (dict keys sort as hits, hwm, seen,
    stock). Stamps are replica-namespaced unless ``tie``."""
    rng = np.random.default_rng(seed * 100 + r)
    k = rng.integers(0, 20, R)
    stamps = k if tie else k * n_rep + r
    slots = np.zeros(n_rep, np.float32)
    slots[r] = rng.uniform(0, 10)
    return {"stock": jlat.VersionedSlots(
                jnp.asarray(rng.random(R) < 0.8),
                jnp.asarray(stamps.astype(np.int32)),
                jnp.asarray(rng.normal(0, 1, (R, W)).astype(np.float32))),
            "hits": jlat.GCounter(jnp.asarray(slots)),
            "hwm": jnp.asarray(rng.integers(0, 99, 4).astype(np.int32)),
            "seen": jnp.asarray(rng.random(16) < 0.2)}


NAMES = ("gcounter", "max", "or", "versioned")


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_merge_many_and_converged_match_reference(n):
    jstates = [_replica_tree(r, n) for r in range(n)]
    tstates = [tree_from_numpy(jax.device_get(s), CPU) for s in jstates]
    assert_same(jmerge.merge_many(NAMES, jstates),
                merge.merge_many(NAMES, tstates), "merge_many")
    if n > 1:
        assert_same(jmerge.merge_trees(NAMES, jstates[0], jstates[1]),
                    merge.merge_trees(NAMES, tstates[0], tstates[1]),
                    "merge_trees")
    assert jmerge.converged(NAMES, jstates)
    assert merge.converged(NAMES, tstates)


def test_converged_detects_divergence_like_reference():
    """Tied stamps with different payloads: the merge depends on the order,
    so replicas do not converge; both packages say so."""
    jstates = [_replica_tree(r, 7, tie=True) for r in range(3)]
    tstates = [tree_from_numpy(jax.device_get(s), CPU) for s in jstates]
    assert_same(jmerge.merge_many(NAMES, jstates),
                merge.merge_many(NAMES, tstates))
    assert jmerge.converged(NAMES, jstates) is False
    assert merge.converged(NAMES, tstates) is False


def test_converged_float_tolerance_like_reference():
    """Float leaves compare with ``allclose`` (``atol``, default
    ``rtol``), bool and int leaves exactly."""
    j = [{"x": jnp.asarray([1.0, 2.0], jnp.float32)},
         {"x": jnp.asarray([1.0, 2.0 + 1e-6], jnp.float32)}]
    t = [tree_from_numpy(jax.device_get(s), CPU) for s in j]
    for atol in (0.0, 1e-3):
        assert merge.converged(("sum",), t, atol=atol) == \
            jmerge.converged(("sum",), j, atol=atol)


def test_merge_many_of_nothing_raises():
    with pytest.raises(ValueError, match="nothing to merge"):
        merge.merge_many(NAMES, [])
    with pytest.raises(ValueError, match="nothing to merge"):
        jmerge.merge_many(NAMES, [])


def test_plan_lattice_names():
    from repro_torch.core.planner import StateSpec, plan_states
    specs = [StateSpec("a", lattice="max", ops=()),
             StateSpec("b", lattice="versioned", ops=())]
    assert merge.plan_lattice_names(plan_states(specs)) == ("max",
                                                            "versioned")
