"""The port's RAMP reads (``repro_torch.txn.ramp``) and its fused RAMP-read
kernel module (``repro_torch.kernels.ramp_read``) against the JAX
package, on the CPU.

* ``ramp_read_plain`` against the JAX oracle ``repro.kernels.ref.
  ramp_read_ref`` and against ``repro.kernels.ops.ramp_read_select``,
  which runs the Pallas kernel in interpret mode off the TPU;
* ``read_lines``, ``apply_order_status``, ``apply_stock_level`` and
  ``delivery_read`` on a state after a few New-Order batches, with lines
  concealed by a seeded mask, against the JAX functions on the same state.

Tolerance: exact, values and dtypes, for every output, ``amount_sum``
included: both sides add a row's selected amounts in line order from 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.txn import ramp as jramp  # noqa: E402
from repro.txn import tpcc as jt  # noqa: E402
from repro_torch.convert import (order_status_batch_from_numpy,  # noqa: E402
                                 state_from_numpy,
                                 stock_level_batch_from_numpy)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ramp_read import ramp_read_plain  # noqa: E402
from repro_torch.txn import ramp  # noqa: E402
from repro_torch.txn import tpcc as tt  # noqa: E402

CPU = "cpu"
SMALL = dict(n_warehouses=2, districts=2, customers=8, n_items=64,
             order_capacity=32, max_lines=15)


def _assert_same(want, got, tag):
    want = jax.device_get(want)
    assert len(want) == len(got), tag
    names = getattr(want, "_fields", range(len(want)))
    for name, x, y in zip(names, want, got):
        x = np.asarray(x)
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype, f"{tag}: {name} {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{tag}: {name}")


def _read_problem(R, L, seed):
    """A seeded fused-read problem shaped like the reference test's: stamps
    that match and miss, partial visibility, prepared lines, nlines from 0
    to L."""
    rng = np.random.default_rng(seed)
    vis = rng.random((R, L)) < 0.6
    return dict(
        req_ts=rng.integers(-1, 40, R).astype(np.int32),
        nlines=rng.integers(0, L + 1, R).astype(np.int32),
        ol_ts=rng.integers(-1, 40, (R, L)).astype(np.int32),
        ol_vis=vis, ol_prep=vis | (rng.random((R, L)) < 0.7),
        amount=rng.uniform(0, 100, (R, L)).astype(np.float32),
        i_id=rng.integers(0, 999, (R, L)).astype(np.int32))


@pytest.mark.parametrize("R,L", [(8, 15), (64, 15), (128, 8), (256, 15),
                                 (100, 15)])
def test_ramp_read_plain_matches_reference(R, L):
    """(100, 15): a row count that no power-of-two block divides."""
    p = _read_problem(R, L, seed=R + L)
    # the stamps must match somewhere for the lookback to have work
    p["ol_ts"][: R // 2] = p["req_ts"][: R // 2, None]
    j = tuple(jnp.asarray(v) for v in p.values())
    t = tuple(torch.from_numpy(v) for v in p.values())
    want = jref.ramp_read_ref(*j)
    _assert_same(want, jops.ramp_read_select(*j), "pallas interpret")
    for tag, got in (("plain", ramp_read_plain(*t)),
                     ("torch oracle", ref.ramp_read_ref(*t)),
                     ("ops on the cpu", ops.ramp_read_select(*t))):
        _assert_same(want, got, tag)
    assert int(np.asarray(want[5]).sum()) > 0      # repairs happened


def test_sum_lines_is_line_order():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1e4, (64, 15)).astype(np.float32)
    seq = np.zeros(64, np.float32)
    for col in x.T:
        seq = seq + col
    np.testing.assert_array_equal(ref.sum_lines(torch.from_numpy(x)).numpy(),
                                  seq)
    np.testing.assert_array_equal(np.asarray(jnp.asarray(x).sum(1)), seq)


LONELY = (0, 0, 7)   # (w, d, c): a customer the staged state has no order of


def _staged_states(seed=9, drop=0.5):
    """A state after six New-Order batches, with customer ``LONELY``'s
    orders handed to another customer, and a copy with ``drop`` of the
    lines concealed by a seeded numpy mask, on both sides."""
    scale = jt.TPCCScale(**SMALL)
    state = jt.init_state(scale, seed=seed)
    rng = np.random.default_rng(seed)
    for i in range(6):
        state, _, _ = jt.apply_neworder(state, jt.generate_neworder(
            rng, scale, 16, ts0=16 * i), scale)
    w, d, c = LONELY
    o_c_id = np.array(state.o_c_id)
    o_c_id[w, d][o_c_id[w, d] == c] = c - 1
    state = state._replace(o_c_id=jnp.asarray(o_c_id))
    mask = rng.random(state.ol_vis.shape) < drop
    staged = jramp.conceal_lines(state, jnp.asarray(mask))
    tstate = state_from_numpy(jax.device_get(state), CPU)
    tstaged = ramp.conceal_lines(tstate, torch.from_numpy(mask))
    return scale, rng, (state, tstate), (staged, tstaged)


def test_conceal_and_publish_leave_the_callers_tensors():
    _, _, (_, t), (_, ts) = _staged_states()
    before = t.ol_vis.clone()
    assert not torch.equal(ts.ol_vis, t.ol_vis)
    assert torch.equal(t.ol_vis, before)
    pub = ramp.publish_lines(ts)
    assert torch.equal(pub.ol_vis, ts.ol_valid)
    assert pub.ol_vis.data_ptr() != ts.ol_valid.data_ptr()


@pytest.mark.parametrize("use_metadata", [True, False])
def test_read_lines_matches_reference(use_metadata):
    scale, rng, _, (js, ts) = _staged_states()
    shape = (5, 7)
    wl = rng.integers(0, 2, shape).astype(np.int32)
    d = rng.integers(0, 2, shape).astype(np.int32)
    slot = rng.integers(0, 32, shape).astype(np.int32)
    want = jramp.read_lines(js, jnp.asarray(wl), jnp.asarray(d),
                            jnp.asarray(slot), use_metadata=use_metadata)
    got = ramp.read_lines(ts, torch.from_numpy(wl), torch.from_numpy(d),
                          torch.from_numpy(slot), use_metadata=use_metadata)
    _assert_same(want, got, "read_lines")
    if use_metadata:
        assert bool(got.repaired.any())


@pytest.mark.parametrize("use_metadata", [True, False])
def test_order_status_matches_reference(use_metadata):
    """Order-Status through the fused read (and the control reader) on a
    staged state. The last query names customer ``LONELY``: no matching
    order."""
    scale, rng, _, (js, ts) = _staged_states()
    jb = jt.generate_order_status(rng, scale, 24)
    jb = jt.OrderStatusBatch(*(x.at[-1].set(v) for x, v in zip(jb, LONELY)))
    want = jramp.apply_order_status(js, jb, use_metadata=use_metadata)
    got = ramp.apply_order_status(
        ts, order_status_batch_from_numpy(jax.device_get(jb), CPU),
        use_metadata=use_metadata)
    _assert_same(want, got, "order status")
    assert not bool(got.found[-1]) and int(got.lines_read[-1]) == 0
    assert bool(got.found.any())
    fractures = int(got.fractures_observed())
    assert fractures == int(want.fractures_observed())
    if use_metadata:
        assert fractures == 0 and int(got.repaired.sum()) > 0
    else:
        assert fractures > 0


def test_order_status_with_no_orders_reads_slot_zero():
    """An empty store: every key ties at -1, both argmaxes take the first
    slot, and nothing is found or read."""
    scale = jt.TPCCScale(**SMALL)
    js = jt.init_state(scale)
    ts = tt.init_state(tt.TPCCScale(**SMALL), device=CPU)
    jb = jt.generate_order_status(np.random.default_rng(1), scale, 6)
    want = jramp.apply_order_status(js, jb)
    got = ramp.apply_order_status(
        ts, order_status_batch_from_numpy(jax.device_get(jb), CPU))
    _assert_same(want, got, "order status, empty store")
    assert not bool(got.found.any()) and int(got.lines_read.sum()) == 0


@pytest.mark.parametrize("use_metadata", [True, False])
def test_stock_level_matches_reference(use_metadata):
    scale, rng, _, (js, ts) = _staged_states()
    jb = jt.generate_stock_level(rng, scale, 12)
    want = jramp.apply_stock_level(js, jb, scale, use_metadata=use_metadata)
    got = ramp.apply_stock_level(
        ts, stock_level_batch_from_numpy(jax.device_get(jb), CPU),
        tt.TPCCScale(**SMALL), use_metadata=use_metadata)
    _assert_same(want, got, "stock level")
    assert int(got.lines_read.sum()) > 0 and int(got.fractured.sum()) > 0


def test_delivery_read_matches_reference():
    _, _, _, (js, ts) = _staged_states()
    want = jramp.delivery_read(js)
    got = ramp.delivery_read(ts)
    _assert_same(want, got, "delivery read")
    assert int(got.repaired.sum()) > 0
