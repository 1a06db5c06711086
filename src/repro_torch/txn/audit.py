"""TPC-C consistency-audit oracle (spec §3.3.2-style conditions), on the
host: it copies a drained state to numpy once and re-derives every
condition from the table arrays —

  * payment flow:   W_YTD == Σ D_YTD == Σ H_AMOUNT (criteria 1/8/9);
  * order flow:     D_NEXT_O_ID == #orders, #NEW-ORDER + #delivered ==
                    #orders, per-order O_OL_CNT == its line count;
  * delivery flow:  carrier/delivered-line/balance bookkeeping;
  * strict stock:   s_quantity >= 0 everywhere AND s_quantity + s_ytd ==
                    initial stock per (warehouse, item) cell;
  * escrow:         Σ_replicas (shares - spent) never negative, and equal
                    to s_quantity at every hot cell with a sorted-unique
                    key table (sparse HotSetEscrow) or at every cell
                    (dense EscrowCounter).

:func:`check_cold_ledger` checks a cold-tier ledger (the retry ring's
accounting) the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .tpcc import check_consistency


@dataclasses.dataclass
class AuditReport:
    ok: bool
    failures: list[str]
    checks: dict[str, bool]

    def describe(self) -> str:
        if self.ok:
            return f"audit OK ({len(self.checks)} conditions)"
        return "audit FAILED: " + ", ".join(self.failures)


def audit_tpcc(state, *, escrow=None, initial_stock=None,
               strict_stock: bool = False, atol: float = 1e-2) -> AuditReport:
    """Audit a drained state. ``escrow`` (the final HotSetEscrow or
    EscrowCounter), ``initial_stock`` (the pre-run ``s_quantity``) and
    ``strict_stock`` enable the escrow-regime conditions."""
    from repro_torch.convert import state_to_numpy

    s = state_to_numpy(state)
    checks: dict[str, bool] = {}

    checks["w_ytd_eq_sum_d_ytd"] = bool(
        np.allclose(s.w_ytd, s.d_ytd.sum(-1), atol=atol))
    checks["d_ytd_eq_history"] = bool(
        np.allclose(s.d_ytd, s.h_amount_sum, atol=atol))

    order_count = s.o_valid.sum(-1)
    no_count = s.no_valid.sum(-1)
    delivered = (s.o_valid & ~s.no_valid).sum(-1)
    checks["d_next_o_id_monotone"] = bool(np.all(s.d_next_o_id >= 0))
    checks["d_next_o_id_counts_orders"] = bool(
        np.array_equal(s.d_next_o_id, order_count))
    checks["order_neworder_delivered_consistent"] = bool(
        np.array_equal(no_count + delivered, order_count))
    checks["o_ol_cnt_matches_lines"] = bool(
        np.all(np.where(s.o_valid, s.o_ol_cnt, 0) == s.ol_valid.sum(-1)))

    deliv_order = s.o_valid & (s.o_carrier >= 0)
    checks["carrier_iff_delivered"] = bool(
        np.all((s.o_carrier < 0) == (s.no_valid | ~s.o_valid)))
    checks["delivered_lines_match_orders"] = bool(
        np.all(s.ol_delivered == (s.ol_valid & deliv_order[..., None])))
    checks["c_balance_materialized"] = bool(
        np.allclose(s.c_balance, s.c_delivered_sum - s.c_ytd_payment,
                    atol=atol))

    checks["twelve_criteria"] = all(check_consistency(s, atol).values())

    if strict_stock or escrow is not None:
        checks["stock_nonnegative"] = bool(np.all(s.s_quantity >= 0))
    if initial_stock is not None:
        q0 = np.asarray(initial_stock.cpu() if torch.is_tensor(initial_stock)
                        else initial_stock, np.int64)
        sold = np.asarray(np.rint(s.s_ytd), np.int64)   # int-valued f32
        checks["stock_conservation"] = bool(
            np.array_equal(s.s_quantity.astype(np.int64) + sold, q0))
        checks["spend_bounded_by_inventory"] = bool(np.all(sold <= q0))
    if escrow is not None:
        e = state_to_numpy(escrow)
        remaining = e.shares.sum(0).astype(np.int64) \
            - e.spent.sum(0).astype(np.int64)
        checks["escrow_remaining_nonnegative"] = bool(np.all(remaining >= 0))
        if hasattr(e, "keys"):
            # sparse layout: after the final drain the escrow view agrees
            # with the owners' stock on every hot cell
            keys = np.asarray(e.keys, np.int64)
            checks["hot_keys_sorted_unique"] = bool(
                np.all(np.diff(keys) > 0)) if keys.size > 1 else True
            q_hot = s.s_quantity.reshape(-1).astype(np.int64)[keys]
            checks["escrow_covers_hot_stock"] = bool(
                np.array_equal(remaining, q_hot))
        else:
            # dense layout: the same law over the whole keyspace
            checks["escrow_covers_stock"] = bool(
                np.array_equal(remaining, s.s_quantity.astype(np.int64)))

    failures = [k for k, v in checks.items() if not v]
    return AuditReport(not failures, failures, checks)


def assert_audit(state, **kwargs) -> AuditReport:
    """Raise AssertionError (with the failed condition names) unless the
    audit passes; returns the report for logging."""
    rep = audit_tpcc(state, **kwargs)
    if not rep.ok:
        raise AssertionError(f"TPC-C audit failed: {rep.failures}")
    return rep


def check_cold_ledger(ledger: dict, *, quiescent: bool = False) -> None:
    """Validate a cold-tier ledger dict, reservations included.

    Always: every optimistically admitted cold line is accounted for
    (``exact``: sent == applied + final rejects + queued + in the ring), and
    every granted reservation is completed or still in a ring
    (``reservations_exact``). With ``quiescent=True`` nothing may still be
    in flight: ``queued``, ``in_ring`` and ``reserved_in_ring`` are 0.
    Raises ``AssertionError`` naming the ledger.
    """
    if not ledger["exact"]:
        raise AssertionError("cold ledger leak: sent != applied + final + "
                             f"queued + in_ring: {ledger}")
    if not ledger.get("reservations_exact", True):
        raise AssertionError("reservation ledger leak: granted != "
                             f"completed + in_ring: {ledger}")
    if quiescent:
        if ledger["queued"] != 0 or ledger["in_ring"] != 0:
            raise AssertionError(f"ledger not quiescent: {ledger}")
        if ledger.get("reserved_in_ring", 0) != 0:
            raise AssertionError("reservation still in flight at "
                                 f"quiescence: {ledger}")
