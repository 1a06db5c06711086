"""The run with the timed path broken underneath comes out not correct,
once for each fault the cells can have. Where one shard holds every
warehouse, the drain exchanges nothing between shards; the exchange the
escrow cells do have is the share refresh, left out below. The faults of
the drain's exchange at R > 1 are in ``test_portbench_shards.py``."""

import pytest
import torch

from repro_torch.txn import tpcc
from repro_torch.txn.engine import Engine
from repro_torch.txn.executor import FusedExecutor

from portbench.tests.tiny import CELLS, cell, drive


def _unchanged(monkeypatch):
    """A chunk that returns its state unchanged."""
    monkeypatch.setattr(FusedExecutor, "_chunk", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    """New-Order on the first half of each shard's part of each batch, the
    rest left out (its outputs padded, shard by shard, to the batch's
    shapes with zeros: outbox entries that are not valid, no commit)."""
    def half(batch, n_shards):
        def cut(x):
            part = x.view(n_shards, -1, *x.shape[1:])
            return part[:, :part.shape[1] // 2].reshape(-1, *x.shape[1:])
        return type(batch)(*(cut(x) for x in batch))

    def pad(x, n_shards, n):
        if isinstance(x, tuple):
            return type(x)(*(pad(y, n_shards, n) for y in x))
        part = x.view(n_shards, -1)
        zero = part.new_zeros((n_shards, n // n_shards - part.shape[1]))
        return torch.cat([part, zero], 1).reshape(-1)

    merge, escrow = Engine.neworder_step, Engine.neworder_escrow_step

    def merge_half(self, s, b):
        R, B = self.n_shards, b.w.shape[0]
        st, delta, total = merge(self, s, half(b, R))
        return st, pad(delta, R, B * b.i_id.shape[1]), pad(total, R, B)

    def escrow_half(self, s, e, b):
        R, B = self.n_shards, b.w.shape[0]
        st, es, delta, total, ok = escrow(self, s, e, half(b, R))
        return (st, es, pad(delta, R, B * b.i_id.shape[1]),
                pad(total, R, B), pad(ok, R, B))
    monkeypatch.setattr(Engine, "neworder_step", merge_half)
    monkeypatch.setattr(Engine, "neworder_escrow_step", escrow_half)


def _no_refresh(monkeypatch):
    """The escrow's share refresh (its one exchange) left out."""
    monkeypatch.setattr(Engine, "refresh_escrow",
                        lambda self, state, esc, alive=None: esc)


def _altered(monkeypatch):
    """One order line's amount altered where New-Order produces it."""
    insert = tpcc._insert_order_rows

    def altered(state, batch, scale, wl, o_id, keep, line_valid, ramp_ts,
                amount, ol_ts):
        amount = amount.clone()
        amount.view(-1)[0] += 0.25
        return insert(state, batch, scale, wl, o_id, keep, line_valid,
                      ramp_ts, amount, ol_ts)
    monkeypatch.setattr(tpcc, "_insert_order_rows", altered)


def _no_exchange(monkeypatch):
    """The drain's exchange between shards left out: no owner applies the
    cross-shard deltas."""
    monkeypatch.setattr(Engine, "anti_entropy", lambda self, state, o: state)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "no_refresh": _no_refresh, "altered": _altered,
          "no_exchange": _no_exchange}


def _applies(workload: str, fault: str) -> bool:
    """The merge regime has no share refresh; one shard has no exchange
    between shards."""
    cfg = cell(workload)[0]
    if fault == "no_refresh":
        return cfg["regime"] == "escrow"
    if fault == "no_exchange":
        return cfg["n_shards"] > 1
    return True


CASES = [(w, f) for w in CELLS for f in FAULTS if _applies(w, f)]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    rec = drive(workload, 21)
    assert rec.correct is False, rec.checks
