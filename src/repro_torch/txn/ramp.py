"""RAMP-Fast atomic visibility over the dense TPC-C store (paper §6, RAMP):
the port of ``repro.txn.ramp``.

* **write** — New-Order stamps its whole write set with one
  replica-namespaced timestamp: the ORDER row is the commit record (its
  ``o_ts`` and ``o_ol_cnt`` are the metadata; the sibling lines are lines
  ``0..n-1`` of the same slot) and every line carries the stamp in
  ``ol_ts``. Prepared data (``ol_valid`` and the payload columns) lands
  before the commit record can be observed; only the committed-layer bit
  ``ol_vis`` may lag, which is how commit propagation across partitions is
  modelled (:func:`conceal_lines`).
* **read, round 1** — a gather from the committed layer (``ol_vis``) plus
  the commit-record metadata.
* **fracture detection** — any needed line that is invisible or carries
  another stamp is fractured.
* **read, round 2 (local lookback)** — fractured lines are re-read from
  the retained prepared versions (``ol_valid``/``ol_ts``).

Order-Status reads its line sets through the fused RAMP-read kernel
(``kernels.ops.ramp_read_select``: the CUDA kernel on the card, its plain
version on the CPU); the reference reads them through :func:`read_lines`,
with the same results. Stock-Level and Delivery's read side stay on
:func:`read_lines`, as in the reference.

The read functions never change the state; :func:`conceal_lines` and
:func:`publish_lines` return a state with a new ``ol_vis`` and leave the
caller's tensors alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops, ref

from .tpcc import OrderStatusBatch, StockLevelBatch, TPCCScale, TPCCState

Tensor = torch.Tensor

# Stock-Level scans the district's last 20 orders (TPC-C §2.8.2.2).
STOCK_LEVEL_ORDERS = 20


# ---------------------------------------------------------------------------
# Visibility staging — models commit propagation across partitions
# ---------------------------------------------------------------------------


def conceal_lines(state: TPCCState, drop: Tensor) -> TPCCState:
    """Hide ``drop`` lines from the committed layer (prepared layer intact):
    the fracture window RAMP tolerates."""
    return state._replace(ol_vis=state.ol_vis & ~drop)


def publish_lines(state: TPCCState) -> TPCCState:
    """Complete commit propagation: committed layer catches up to prepared."""
    return state._replace(ol_vis=state.ol_valid.clone())


# ---------------------------------------------------------------------------
# The RAMP read primitive
# ---------------------------------------------------------------------------


class LineRead(NamedTuple):
    """Per-line result of a RAMP read of one order's line set."""

    present: Tensor    # [..., L] bool — line returned to the client
    repaired: Tensor   # [..., L] bool — served by the 2nd (lookback) round
    fractured: Tensor  # [..., L] bool — needed but missing from round 1


def read_lines(state: TPCCState, wl: Tensor, d: Tensor, slot: Tensor,
               *, use_metadata: bool = True) -> LineRead:
    """Two-round RAMP-Fast read of the order line sets at ``(wl, d, slot)``
    (equal-shaped index tensors, shard-local warehouse). With
    ``use_metadata=False`` the reader trusts the committed layer alone (the
    control that does observe fractures)."""
    at = (wl.long(), d.long(), slot.long())
    L = state.ol_valid.shape[-1]
    req_ts = state.o_ts[at]
    nlines = state.o_ol_cnt[at]
    line = torch.arange(L, dtype=torch.int32, device=req_ts.device)
    need = line < nlines[..., None]
    match = state.ol_ts[at] == req_ts[..., None]
    round1 = state.ol_vis[at] & match & need
    fractured = need & ~round1
    if not use_metadata:
        return LineRead(round1, torch.zeros_like(round1), fractured)
    repaired = fractured & state.ol_valid[at] & match
    return LineRead(round1 | repaired, repaired, fractured)


# ---------------------------------------------------------------------------
# Order-Status (§2.6)
# ---------------------------------------------------------------------------


class OrderStatusResult(NamedTuple):
    found: Tensor       # [B] bool — the customer has a visible order
    balance: Tensor     # [B] C_BALANCE
    entry_ts: Tensor    # [B] O_ENTRY_D of the order read
    n_lines: Tensor     # [B] sibling count from the commit-record metadata
    lines_read: Tensor  # [B] lines actually returned
    repaired: Tensor    # [B] lines served by the lookback round
    i_id: Tensor        # [B, L]
    qty: Tensor         # [B, L]
    amount: Tensor      # [B, L]
    delivered: Tensor   # [B, L] bool

    def fractures_observed(self) -> Tensor:
        """Orders returned with an incomplete line set (never under RAMP)."""
        return (self.found & (self.lines_read < self.n_lines)).sum()


def order_status_slots(state: TPCCState, batch: OrderStatusBatch,
                       w_lo: int = 0) -> tuple[Tensor, Tensor]:
    """Each query's most recent visible commit record for its customer
    (``o_ts`` is the replica-namespaced stamp, monotone in the logical
    clock). Returns (slot [B] int64, found [B] bool); with no such order
    the slot is 0, the first of equal keys, as in the reference."""
    wl, d = (batch.w - w_lo).long(), batch.d.long()
    o_ts = state.o_ts[wl, d]                                       # [B, OC]
    cand = (state.o_valid[wl, d] & (o_ts >= 0)
            & (state.o_c_id[wl, d] == batch.c[:, None]))
    slot = torch.where(cand, o_ts, -1).argmax(-1)
    return slot, cand.any(-1)


def order_status_lines(state: TPCCState, batch: OrderStatusBatch,
                       slot: Tensor, found: Tensor, w_lo: int = 0
                       ) -> tuple[Tensor, ...]:
    """The fused read's problem for the queries' orders: ``(req_ts, nlines,
    ol_ts, ol_vis, ol_prep, amount, i_id)`` for
    ``kernels.ops.ramp_read_select``. ``nlines`` is 0 where no order was
    found, so nothing is needed there and every line comes back absent."""
    at = ((batch.w - w_lo).long(), batch.d.long(), slot)
    return (state.o_ts[at],
            torch.where(found, state.o_ol_cnt[at], 0),
            state.ol_ts[at], state.ol_vis[at], state.ol_valid[at],
            state.ol_amount[at], state.ol_i_id[at])


def apply_order_status(state: TPCCState, batch: OrderStatusBatch,
                       w_lo: int = 0, *, use_metadata: bool = True
                       ) -> OrderStatusResult:
    """Customer's most recent order and its complete line set. Read-only,
    shard-local. The RAMP reader goes through the fused read
    (``ops.ramp_read_select``); ``use_metadata=False``, the control reader,
    through :func:`read_lines`."""
    wl, d, c = (batch.w - w_lo).long(), batch.d.long(), batch.c.long()
    slot, found = order_status_slots(state, batch, w_lo)
    at = (wl, d, slot)
    if use_metadata:
        present, amount, i_id, _, lines_read, repaired = \
            ops.ramp_read_select(*order_status_lines(state, batch, slot,
                                                     found, w_lo))
    else:
        lr = read_lines(state, wl, d, slot, use_metadata=False)
        present = lr.present & found[:, None]
        amount = torch.where(present, state.ol_amount[at], 0.0)
        i_id = torch.where(present, state.ol_i_id[at], -1)
        lines_read = present.sum(-1).to(torch.int32)
        repaired = (lr.repaired & found[:, None]).sum(-1).to(torch.int32)
    return OrderStatusResult(
        found=found,
        balance=state.c_balance[wl, d, c],
        entry_ts=torch.where(found, state.o_entry_d[at], -1),
        n_lines=torch.where(found, state.o_ol_cnt[at], 0),
        lines_read=lines_read,
        repaired=repaired,
        i_id=i_id,
        qty=torch.where(present, state.ol_qty[at], 0),
        amount=amount,
        delivered=present & state.ol_delivered[at],
    )


# ---------------------------------------------------------------------------
# Stock-Level (§2.8)
# ---------------------------------------------------------------------------


class StockLevelResult(NamedTuple):
    low_count: Tensor   # [B] distinct recent items with S_QUANTITY < threshold
    lines_read: Tensor  # [B] order lines returned across the scanned orders
    repaired: Tensor    # [B] lines served by the lookback round
    fractured: Tensor   # [B] lines a metadata-less reader would have missed


def apply_stock_level(state: TPCCState, batch: StockLevelBatch,
                      scale: TPCCScale, w_lo: int = 0,
                      *, use_metadata: bool = True) -> StockLevelResult:
    """Distinct items in the district's last 20 orders with low home stock.
    The order/order-line join goes through the RAMP read; the stock probe
    reads the warehouse-local table."""
    OC = scale.order_capacity
    K = min(STOCK_LEVEL_ORDERS, OC)
    wl, d = (batch.w - w_lo).long(), batch.d.long()
    B = wl.shape[0]
    dev = wl.device

    next_oid = state.d_next_o_id[wl, d]                            # [B]
    oid = next_oid[:, None] - 1 - torch.arange(K, dtype=torch.int32,
                                               device=dev)[None, :]
    in_ring = (oid >= 0) & (oid >= next_oid[:, None] - OC)
    slot = torch.where(in_ring, oid % OC, 0)

    wK = wl[:, None].expand(B, K)
    dK = d[:, None].expand(B, K)
    lr = read_lines(state, wK, dK, slot, use_metadata=use_metadata)
    present = lr.present & in_ring[..., None]                      # [B, K, L]

    # distinct items through a dense per-query bitmap (sentinel column I
    # for absent lines keeps the scatter's shape fixed)
    I = scale.n_items
    items = torch.where(present, state.ol_i_id[wK, dK, slot.long()], I)
    qidx = torch.arange(B, device=dev)[:, None, None].expand(items.shape)
    seen = torch.zeros((B, I + 1), dtype=torch.bool, device=dev)
    seen.index_put_((qidx.reshape(-1), items.reshape(-1).long()),
                    torch.ones((), dtype=torch.bool, device=dev))
    low = seen[:, :I] & (state.s_quantity[wl] < batch.threshold[:, None])
    ring = in_ring[..., None]
    return StockLevelResult(
        low_count=low.sum(-1).to(torch.int32),
        lines_read=present.sum((-1, -2)).to(torch.int32),
        repaired=(lr.repaired & ring).sum((-1, -2)).to(torch.int32),
        fractured=(lr.fractured & ring).sum((-1, -2)).to(torch.int32),
    )


# ---------------------------------------------------------------------------
# Delivery's read side (§2.7) — what apply_delivery consumes
# ---------------------------------------------------------------------------


class DeliveryRead(NamedTuple):
    has: Tensor       # [W, D] an undelivered order exists
    slot: Tensor      # [W, D] its ring slot
    cust: Tensor      # [W, D] its customer
    amount: Tensor    # [W, D] complete (RAMP-repaired) line amount sum
    repaired: Tensor  # [W, D] lines the lookback round had to serve


def delivery_read(state: TPCCState) -> DeliveryRead:
    """Oldest undelivered order per district with its complete amount sum
    (in line order), repaired through the prepared layer: a fractured read
    here would corrupt C_BALANCE (criteria 10/12)."""
    W, D, _ = state.no_valid.shape
    dev = state.no_valid.device
    key = torch.where(state.no_valid, state.o_entry_d,
                      torch.iinfo(torch.int32).max)
    slot = key.argmin(2)                                           # [W, D]
    has = state.no_valid.any(2)
    wI = torch.arange(W, device=dev)[:, None].expand(W, D)
    dI = torch.arange(D, device=dev)[None, :].expand(W, D)
    lr = read_lines(state, wI, dI, slot)
    amt = ref.sum_lines(torch.where(lr.present, state.ol_amount[wI, dI, slot],
                                    0.0))
    return DeliveryRead(has=has, slot=slot.to(torch.int32),
                        cust=state.o_c_id[wI, dI, slot],
                        amount=amt * has,
                        repaired=lr.repaired.sum(-1).to(torch.int32))
