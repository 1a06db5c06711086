"""The frozen copies equal the port's at this commit: the initial
tables' draws and the streams draw for draw, and B3's byte count the
smoke test's (``chip_smoke.ramp_read_bytes``). B2's count leaves out the
port's dense product slabs on purpose; it is held to its own rule."""

import numpy as np
import pytest
import torch

from repro_torch.txn import tpcc
from repro_torch.txn.drivers import generate_mix_batches, run_loop
from repro_torch.txn.engine import Engine

from portbench.frozen import kernel_bytes, tpcc_inputs
from portbench.tests.tiny import SCALE

PORT_SCALE = tpcc.TPCCScale(**SCALE)
FROZEN_SCALE = tpcc_inputs.Scale(**SCALE)


def _eq(frozen: dict, port) -> None:
    for f in port._fields:
        np.testing.assert_array_equal(frozen[f], getattr(port, f).numpy(),
                                      err_msg=f)


@pytest.mark.parametrize("seed", [0, 17, 2**31 + 1])
def test_initial_draws(seed):
    port = tpcc.init_state(PORT_SCALE, seed=seed, device="cpu")
    d = tpcc_inputs.initial_draws(FROZEN_SCALE, np.random.default_rng(seed))
    np.testing.assert_array_equal(d.price, port.i_price[0].numpy())
    np.testing.assert_array_equal(d.w_tax, port.w_tax.numpy())
    np.testing.assert_array_equal(d.d_tax, port.d_tax.numpy())
    np.testing.assert_array_equal(d.c_discount, port.c_discount.numpy())
    np.testing.assert_array_equal(d.s_quantity, port.s_quantity.numpy())


@pytest.mark.parametrize("skew", [0.0, 1.2])
def test_mix_stream(skew):
    eng = Engine(PORT_SCALE, device="cpu")
    no, pay, os_, sl = generate_mix_batches(
        eng, batch_per_shard=5, n_batches=3, remote_frac=0.3,
        read_frac=0.5, seed=4, item_skew=skew)
    s = tpcc_inputs.pass_stream(
        np.random.default_rng(4), FROZEN_SCALE, batch=5, n_batches=3,
        remote_frac=0.3, item_skew=skew, payments=True, reads=True,
        read_frac=0.5)
    for mine, theirs in ((s.neworder, no), (s.payment, pay),
                         (s.order_status, os_), (s.stock_level, sl)):
        for a, b in zip(mine, theirs, strict=True):
            _eq(a, b)


@pytest.mark.parametrize("payments", [False, True])
def test_neworder_stream(payments, monkeypatch):
    """``run_loop``'s own stream (no reads): the New-Order batches, then
    the Payment batches, from one generator."""
    seen = {}

    def capture(engine, state, esc, no_b, pay_b, os_b, sl_b, **kw):
        seen.update(no=no_b, pay=pay_b)
        raise StopIteration

    from repro_torch.txn import drivers
    monkeypatch.setattr(drivers, "_fused_loop", capture)
    eng = Engine(PORT_SCALE, device="cpu")
    state = tpcc.init_state(PORT_SCALE, device="cpu")
    with pytest.raises(StopIteration):
        run_loop(eng, state, batch_per_shard=6, n_batches=4, seed=9,
                 item_skew=1.2, payments=payments)
    s = tpcc_inputs.pass_stream(
        np.random.default_rng(9), FROZEN_SCALE, batch=6, n_batches=4,
        remote_frac=0.01, item_skew=1.2, payments=payments, reads=False,
        read_frac=0.25)
    for a, b in zip(s.neworder, seen["no"], strict=True):
        _eq(a, b)
    assert (s.payment is None) == (seen["pay"] is None)
    for a, b in zip(s.payment or [], seen["pay"] or [], strict=True):
        _eq(a, b)


def test_ramp_read_bytes_equal_the_smoke_tests():
    import chip_smoke
    from repro_torch.kernels import ref
    from repro_torch.txn import ramp

    eng = Engine(PORT_SCALE, device="cpu")
    state = tpcc.init_state(PORT_SCALE, device="cpu")
    rng = np.random.default_rng(2)
    batch, _ = tpcc.neworder_batch(eng, rng, 12, 0.0, 0)
    eng.neworder_step(state, batch)
    osb = tpcc.OrderStatusBatch(batch.w[:6], batch.d[:6],
                                torch.cat([batch.c[:3], batch.c[3:6] + 1]))
    # a concealed line, so the lookback has work
    state = ramp.conceal_lines(state, torch.zeros_like(state.ol_vis)
                               .index_fill_(3, torch.tensor([1]), True))
    slot, found = ramp.order_status_slots(state, osb)
    args = ramp.order_status_lines(state, osb, slot, found)
    got = ref.ramp_read_ref(*args)
    want, _ = chip_smoke.ramp_read_bytes(args, got)
    req_ts, nlines, ol_ts, ol_vis = args[:4]
    need = torch.arange(ol_ts.shape[1])[None, :] < nlines[:, None]
    match = need & (ol_ts == req_ts[:, None])
    mine, ops = kernel_bytes.ramp_read(
        osb.w.shape[0], ol_ts.shape[1], int(need.sum()), int(match.sum()),
        int((match & ~ol_vis).sum()), int(got[0].sum()))
    assert mine == want
    assert ops == osb.w.shape[0] * ol_ts.shape[1]


def test_txn_megastep_bytes_rule():
    L = 4
    batch = dict(w=np.array([0, 1, 0], np.int32),
                 d=np.array([1, 1, 1], np.int32),
                 n_lines=np.array([2, 1, 3], np.int32),
                 i_id=np.array([[5, 5, 0, 0], [7, 0, 0, 0], [5, 6, 7, 0]],
                               np.int32),
                 supply_w=np.array([[0, 0, 9, 9], [1, 9, 9, 9],
                                    [0, 2, 1, 9]], np.int32))
    nbytes, ops = kernel_bytes.txn_megastep(batch, 10, 0, 2)
    B, cells, prices, keys, local = 3, 3, 4, 2, 2
    assert nbytes == (16 * B + 12 * B * L + 8 * cells + 4 * prices
                      + 8 * keys + 12 * local + 5 * B + 8 * B * L)
    assert ops == B * L
