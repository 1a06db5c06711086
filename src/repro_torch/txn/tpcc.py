"""TPC-C in PyTorch — schema, the transaction streams, New-Order in the
merge and escrow regimes, Payment and Delivery, and the twelve consistency
criteria (paper §6.2).

The port of ``repro.txn.tpcc``. State is dense and warehouse-major, with
the reference's field names, layouts and dtypes (int32, bool, float32;
int64 only where torch indexes). The numpy draws of :func:`init_state`
and the ``generate_*`` functions are the reference's, so the same seed
gives both packages the same inputs. Float sums follow the reference's
order: over an order's lines in line order (``kernels.ref.sum_lines``),
and Payment's scatter-adds in batch order.

Unlike the reference's pure functions, the ``apply_*`` functions here
update the state's tensors IN PLACE (the reference donates the same
buffers under ``jit``) and return the state for chaining. Copy a state
first (``TPCCState(*(x.clone() for x in s))``) to keep the old one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.invariants import Invariant, InvariantKind
from repro_torch.core.lattice import hot_position
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops, ref
from repro_torch.kernels.txn_megastep import (MegastepOut,
                                              megastep_effect_products)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TPCCScale:
    n_warehouses: int = 4
    districts: int = 10          # districts per warehouse (spec: 10)
    customers: int = 64          # customers per district (spec: 3000)
    n_items: int = 256           # item catalog (spec: 100_000)
    order_capacity: int = 128    # order slots per district (ring)
    max_lines: int = 15          # order lines per order (spec: 5..15)

    @staticmethod
    def spec_scale(n_warehouses: int = 256) -> "TPCCScale":
        """Full TPC-C per-warehouse cardinalities (TPC-C standard
        specification, clause 4.3.3.1) with the repo's 8192-order ring."""
        return TPCCScale(n_warehouses=n_warehouses, districts=10,
                         customers=3000, n_items=100_000,
                         order_capacity=8192, max_lines=15)


class TPCCState(NamedTuple):
    """All tables, warehouse-major (the reference's layout)."""

    # WAREHOUSE
    w_ytd: Tensor        # [W] f32
    w_tax: Tensor        # [W] f32
    # DISTRICT
    d_next_o_id: Tensor  # [W, D] int32 — THE sequential counter (§6.2)
    d_ytd: Tensor        # [W, D] f32
    d_tax: Tensor        # [W, D] f32
    h_amount_sum: Tensor  # [W, D] f32 materialized history sum
    # CUSTOMER
    c_balance: Tensor       # [W, D, C] f32
    c_ytd_payment: Tensor   # [W, D, C] f32
    c_payment_cnt: Tensor   # [W, D, C] int32
    c_delivery_cnt: Tensor  # [W, D, C] int32
    c_discount: Tensor      # [W, D, C] f32
    c_delivered_sum: Tensor  # [W, D, C] f32
    # STOCK
    s_quantity: Tensor    # [W, I] int32
    s_ytd: Tensor         # [W, I] f32
    s_order_cnt: Tensor   # [W, I] int32
    s_remote_cnt: Tensor  # [W, I] int32
    # ITEM (read-only; replicated per warehouse)
    i_price: Tensor       # [W, I] f32
    # ORDER / NEW-ORDER / ORDER-LINE (ring-buffered per district)
    o_valid: Tensor    # [W, D, OC] bool
    o_c_id: Tensor     # [W, D, OC] int32
    o_ol_cnt: Tensor   # [W, D, OC] int32
    o_carrier: Tensor  # [W, D, OC] int32 (-1 = undelivered)
    o_entry_d: Tensor  # [W, D, OC] int32
    no_valid: Tensor   # [W, D, OC] bool
    ol_valid: Tensor      # [W, D, OC, L] bool — prepared layer
    ol_i_id: Tensor       # [W, D, OC, L] int32
    ol_supply_w: Tensor   # [W, D, OC, L] int32
    ol_qty: Tensor        # [W, D, OC, L] int32
    ol_amount: Tensor     # [W, D, OC, L] f32
    ol_delivered: Tensor  # [W, D, OC, L] bool
    # RAMP atomic-visibility metadata
    o_ts: Tensor    # [W, D, OC] int32 (-1 = none)
    ol_ts: Tensor   # [W, D, OC, L] int32 (-1 = none)
    ol_vis: Tensor  # [W, D, OC, L] bool


def init_state(scale: TPCCScale, seed: int = 0, device=None) -> TPCCState:
    """Initial tables from the reference's numpy draws (same seed, same
    values), on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    W, D, C = scale.n_warehouses, scale.districts, scale.customers
    I, OC, L = scale.n_items, scale.order_capacity, scale.max_lines
    price = rng.uniform(1.0, 100.0, size=(I,)).astype(np.float32)
    w_tax = rng.uniform(0.0, 0.2, (W,)).astype(np.float32)
    d_tax = rng.uniform(0.0, 0.2, (W, D)).astype(np.float32)
    c_discount = rng.uniform(0.0, 0.5, (W, D, C)).astype(np.float32)
    s_quantity = rng.integers(10, 101, (W, I)).astype(np.int32)

    def put(a):
        return torch.from_numpy(a).to(dev)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    f32, i32, b = torch.float32, torch.int32, torch.bool
    return TPCCState(
        w_ytd=full((W,), 0, f32), w_tax=put(w_tax),
        d_next_o_id=full((W, D), 0, i32), d_ytd=full((W, D), 0, f32),
        d_tax=put(d_tax), h_amount_sum=full((W, D), 0, f32),
        c_balance=full((W, D, C), 0, f32),
        c_ytd_payment=full((W, D, C), 0, f32),
        c_payment_cnt=full((W, D, C), 0, i32),
        c_delivery_cnt=full((W, D, C), 0, i32),
        c_discount=put(c_discount),
        c_delivered_sum=full((W, D, C), 0, f32),
        s_quantity=put(s_quantity), s_ytd=full((W, I), 0, f32),
        s_order_cnt=full((W, I), 0, i32), s_remote_cnt=full((W, I), 0, i32),
        i_price=put(price).expand(W, I).contiguous(),
        o_valid=full((W, D, OC), False, b), o_c_id=full((W, D, OC), 0, i32),
        o_ol_cnt=full((W, D, OC), 0, i32),
        o_carrier=full((W, D, OC), -1, i32),
        o_entry_d=full((W, D, OC), 0, i32),
        no_valid=full((W, D, OC), False, b),
        ol_valid=full((W, D, OC, L), False, b),
        ol_i_id=full((W, D, OC, L), 0, i32),
        ol_supply_w=full((W, D, OC, L), 0, i32),
        ol_qty=full((W, D, OC, L), 0, i32),
        ol_amount=full((W, D, OC, L), 0, f32),
        ol_delivered=full((W, D, OC, L), False, b),
        o_ts=full((W, D, OC), -1, i32),
        ol_ts=full((W, D, OC, L), -1, i32),
        ol_vis=full((W, D, OC, L), False, b),
    )


def state_shape_dtypes(scale: TPCCScale) -> TPCCState:
    """The tables' shapes and dtypes as meta tensors, allocating none of
    the tables (only :func:`init_state`'s host draws): the template a
    checkpoint restores into (the reference's ``tpcc.state_shape_dtypes``)."""
    return init_state(scale, device="meta")


# ---------------------------------------------------------------------------
# Transaction inputs
# ---------------------------------------------------------------------------


class NewOrderBatch(NamedTuple):
    w: Tensor          # [B] home warehouse
    d: Tensor          # [B] district
    c: Tensor          # [B] customer
    n_lines: Tensor    # [B] 5..15
    i_id: Tensor       # [B, L] item ids
    supply_w: Tensor   # [B, L] supplying warehouse (1% remote in spec)
    qty: Tensor        # [B, L] 1..10
    ts: Tensor         # [B] logical entry timestamp


class PaymentBatch(NamedTuple):
    w: Tensor       # [B]
    d: Tensor       # [B]
    c: Tensor       # [B]
    amount: Tensor  # [B]


class OrderStatusBatch(NamedTuple):
    """Order-Status (TPC-C §2.6): customer's most recent order + its lines."""

    w: Tensor  # [B]
    d: Tensor  # [B]
    c: Tensor  # [B]


class StockLevelBatch(NamedTuple):
    """Stock-Level (TPC-C §2.8): distinct recently-ordered items whose home
    stock sits below a threshold."""

    w: Tensor          # [B]
    d: Tensor          # [B]
    threshold: Tensor  # [B] int32 (spec: 10..20)


def _on(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def generate_neworder(rng: np.random.Generator, scale: TPCCScale, batch: int,
                      remote_frac: float = 0.01,
                      w_lo: int = 0, w_hi: int | None = None,
                      ts0: int = 0, item_skew: float = 0.0,
                      device=None) -> NewOrderBatch:
    """Random New-Order inputs for home warehouses in [w_lo, w_hi) — the
    reference's numpy stream, draw for draw. ``item_skew`` > 0 draws item
    ids from the Zipfian profile (:func:`item_popularity`)."""
    dev = resolve_device(device)
    w_hi = scale.n_warehouses if w_hi is None else w_hi
    L = scale.max_lines
    w = rng.integers(w_lo, w_hi, batch).astype(np.int32)
    n_lines = rng.integers(5, L + 1, batch).astype(np.int32)
    if item_skew > 0:
        cdf = np.cumsum(item_popularity(scale.n_items, item_skew))
        i_id = np.searchsorted(cdf, rng.random((batch, L))).astype(np.int32)
        i_id = np.minimum(i_id, scale.n_items - 1)
    else:
        i_id = rng.integers(0, scale.n_items, (batch, L)).astype(np.int32)
    remote = rng.random((batch, L)) < remote_frac
    other = rng.integers(0, scale.n_warehouses, (batch, L)).astype(np.int32)
    supply = np.where(remote, other, w[:, None]).astype(np.int32)
    d = rng.integers(0, scale.districts, batch).astype(np.int32)
    c = rng.integers(0, scale.customers, batch).astype(np.int32)
    qty = rng.integers(1, 11, (batch, L)).astype(np.int32)
    ts = (ts0 + np.arange(batch)).astype(np.int32)
    return NewOrderBatch(*_on(dev, w, d, c, n_lines, i_id, supply, qty, ts))


def generate_payment(rng: np.random.Generator, scale: TPCCScale, batch: int,
                     w_lo: int = 0, w_hi: int | None = None,
                     device=None) -> PaymentBatch:
    """Random Payment inputs, the reference's numpy stream draw for draw."""
    dev = resolve_device(device)
    w_hi = scale.n_warehouses if w_hi is None else w_hi
    w = rng.integers(w_lo, w_hi, batch).astype(np.int32)
    d = rng.integers(0, scale.districts, batch).astype(np.int32)
    c = rng.integers(0, scale.customers, batch).astype(np.int32)
    amount = rng.uniform(1.0, 5000.0, batch).astype(np.float32)
    return PaymentBatch(*_on(dev, w, d, c, amount))


def generate_order_status(rng: np.random.Generator, scale: TPCCScale,
                          batch: int, w_lo: int = 0, w_hi: int | None = None,
                          device=None) -> OrderStatusBatch:
    """Random Order-Status inputs, the reference's numpy stream."""
    dev = resolve_device(device)
    w_hi = scale.n_warehouses if w_hi is None else w_hi
    w = rng.integers(w_lo, w_hi, batch).astype(np.int32)
    d = rng.integers(0, scale.districts, batch).astype(np.int32)
    c = rng.integers(0, scale.customers, batch).astype(np.int32)
    return OrderStatusBatch(*_on(dev, w, d, c))


def generate_stock_level(rng: np.random.Generator, scale: TPCCScale,
                         batch: int, w_lo: int = 0, w_hi: int | None = None,
                         device=None) -> StockLevelBatch:
    """Random Stock-Level inputs, the reference's numpy stream."""
    dev = resolve_device(device)
    w_hi = scale.n_warehouses if w_hi is None else w_hi
    w = rng.integers(w_lo, w_hi, batch).astype(np.int32)
    d = rng.integers(0, scale.districts, batch).astype(np.int32)
    threshold = rng.integers(10, 21, batch).astype(np.int32)
    return StockLevelBatch(*_on(dev, w, d, threshold))


def home_partitioned(gen, rng: np.random.Generator, engine, per_shard: int,
                     **kw):
    """One batch of ``gen``'s transactions, ``per_shard`` homed on each of
    ``engine``'s shards in shard order (``engine``: its ``scale``,
    ``n_shards``, ``w_per_shard`` and ``device``)."""
    parts = [gen(rng, engine.scale, per_shard,
                 w_lo=s * engine.w_per_shard,
                 w_hi=(s + 1) * engine.w_per_shard, device=engine.device,
                 **kw)
             for s in range(engine.n_shards)]
    return type(parts[0])(*(torch.cat(xs) for xs in zip(*parts)))


def neworder_batch(engine, rng: np.random.Generator, batch_per_shard: int,
                   remote_frac: float, ts0: int,
                   item_skew: float = 0.0) -> tuple[NewOrderBatch, int]:
    """One home-partitioned New-Order batch, each shard's part stamped
    after the previous one's; returns (batch, advanced ts0). The single
    source of the stream layout."""
    parts = []
    for s in range(engine.n_shards):
        parts.append(generate_neworder(
            rng, engine.scale, batch_per_shard, remote_frac=remote_frac,
            w_lo=s * engine.w_per_shard, w_hi=(s + 1) * engine.w_per_shard,
            ts0=ts0, item_skew=item_skew, device=engine.device))
        ts0 += batch_per_shard
    return NewOrderBatch(*(torch.cat(xs) for xs in zip(*parts))), ts0


def copy_tree(t):
    """A copy of a tuple of tensors (a state, a batch, an escrow)."""
    return type(t)(*(x.clone() for x in t))


# ---------------------------------------------------------------------------
# Remote stock deltas (the RAMP-style asynchronous write set)
# ---------------------------------------------------------------------------


class StockDelta(NamedTuple):
    """COO outbox of stock updates destined for non-local warehouses
    (capacity R = B * L; ``valid`` marks live entries)."""

    dst_w: Tensor  # [R] int32 destination warehouse
    i_id: Tensor   # [R] int32
    qty: Tensor    # [R] int32 ordered quantity
    valid: Tensor  # [R] bool


def _flat_cells(w_idx: Tensor, i_idx: Tensor, mask: Tensor,
                table: Tensor) -> Tensor:
    """The cells ``w * I + i`` of ``table.view(-1)`` that the masked lanes
    name; every other lane gets a cell of its own, ``lane % numel``, where
    it adds zero, so no run of duplicates piles up on one dump cell."""
    lane = torch.arange(mask.shape[0], device=mask.device)
    return torch.where(mask, w_idx.long() * table.shape[1] + i_idx.long(),
                       lane % table.numel())


def apply_stock_updates(state: TPCCState, w_idx: Tensor, i_idx: Tensor,
                        qty: Tensor, mask: Tensor, remote: Tensor,
                        restock: bool = True) -> TPCCState:
    """Owner-side stock effect (TPC-C §2.4.2.2): S_YTD += qty,
    S_ORDER_CNT += 1, S_REMOTE_CNT += remote, S_QUANTITY -= qty, then, with
    ``restock``, +91 while below 10 (the float32 ceil rule of the
    reference). ``restock=False`` is the strict-stock regime.

    The four columns take ``index_add_`` on flat views (``view``, never
    ``reshape``, which would copy a non-contiguous view and drop the
    writes), a masked lane adding zero at a cell of its own
    (:func:`_flat_cells`). Integer adds are exact in any order; so is
    S_YTD's, whose addends are integers far below 2**24 and whose cells
    are never -0.0, so a masked lane's +0.0 leaves their bits."""
    cell = _flat_cells(w_idx, i_idx, mask, state.s_quantity)
    qty_m = torch.where(mask, qty, 0)
    state.s_ytd.view(-1).index_add_(0, cell, qty_m.to(state.s_ytd.dtype))
    state.s_order_cnt.view(-1).index_add_(0, cell, mask.to(torch.int32))
    state.s_remote_cnt.view(-1).index_add_(0, cell,
                                           (mask & remote).to(torch.int32))
    s_q = state.s_quantity
    s_q.view(-1).index_add_(0, cell, -qty_m)
    if restock:
        deficit = torch.ceil((10 - s_q) / 91.0).clamp_min(0).to(torch.int32)
        s_q.copy_(torch.where(s_q < 10, s_q + deficit * 91, s_q))
    return state


def _cold_fits(s_quantity: Tensor, w_idx: Tensor, i_idx: Tensor,
               qty: Tensor, cold: Tensor) -> Tensor:
    """[N] bool: the cold lane's cell's total cold demand fits its stock
    (the per-cell all-or-nothing rule), read at the lanes' own cells."""
    cell = _flat_cells(w_idx, i_idx, cold, s_quantity)
    demand = torch.zeros_like(s_quantity).view(-1)
    demand.index_add_(0, cell, torch.where(cold, qty, 0))
    return cold & (demand[cell] <= s_quantity.view(-1)[cell])


# ---------------------------------------------------------------------------
# New-Order (the paper's measured transaction)
# ---------------------------------------------------------------------------


class FlatLines(NamedTuple):
    """Flattened ``[B*L]`` order-line views shared by admission, effects and
    the outbox build (the mask-independent parts)."""

    w: Tensor       # [N] int32 supply warehouse (GLOBAL id)
    i: Tensor       # [N] int32 item id
    q: Tensor       # [N] int32 quantity
    local: Tensor   # [N] bool — supply warehouse within [w_lo, w_hi)
    remote: Tensor  # [N] bool — supply warehouse != the order's home w


def flatten_order_lines(batch: NewOrderBatch, w_lo: int,
                        w_hi: int) -> FlatLines:
    """THE order-line flattening, one definition for every consumer."""
    flat_w = batch.supply_w.reshape(-1)
    return FlatLines(
        w=flat_w, i=batch.i_id.reshape(-1), q=batch.qty.reshape(-1),
        local=(flat_w >= w_lo) & (flat_w < w_hi),
        remote=(batch.supply_w != batch.w[:, None]).reshape(-1))


def _put_rows(table: Tensor, flat: Tensor, vals, keep: Tensor | None):
    """``table.view(-1, ...)[flat[b]] = vals[b]`` for the rows with
    ``keep[b]`` (every row when ``keep`` is None).

    The reference drops aborted rows with ``mode="drop"``; torch has none,
    and masking by ``nonzero`` would synchronise with the host. So a
    dropped row is redirected to repeat the first kept row's write (same
    index, same value, so duplicates cannot race), or, when no row is kept,
    to rewrite row 0's current value: a no-op either way. Nothing here
    reads back to the host (a 0-d index tensor would: it is read as an
    int), so a CUDA graph can capture it.
    """
    view = table.view(-1, *table.shape[3:])
    if torch.is_tensor(vals):
        vals = vals.to(table.dtype)
    else:
        vals = torch.full((), vals, dtype=table.dtype, device=table.device)
    vals = vals.expand(flat.shape[0], *table.shape[3:])
    if keep is not None:
        j = keep.to(torch.int32).argmax().reshape(1)
        row_keep = keep.reshape(-1, *([1] * (table.dim() - 3)))
        first = flat.index_select(0, j)
        fallback = torch.where(keep.any(), vals.index_select(0, j),
                               view.index_select(0, first))
        vals = torch.where(row_keep, vals, fallback)
        flat = torch.where(keep, flat, first)
    view.index_put_((flat,), vals)


def _insert_order_rows(state: TPCCState, batch: NewOrderBatch, scale,
                       wl: Tensor, o_id: Tensor, keep: Tensor | None,
                       line_valid: Tensor, ramp_ts: Tensor, amount: Tensor,
                       ol_ts: Tensor) -> None:
    """ORDER + NEW-ORDER + ORDER-LINE inserts of each (kept) transaction
    at ring slot ``o_id % OC``; each insert writes the order's whole line
    row, invalid tail included."""
    D, OC = scale.districts, scale.order_capacity
    flat = ((wl.long() * D + batch.d.long()) * OC + (o_id % OC).long())
    for table, vals in (
            (state.o_valid, True), (state.o_c_id, batch.c),
            (state.o_ol_cnt, batch.n_lines), (state.o_carrier, -1),
            (state.o_entry_d, batch.ts), (state.no_valid, True),
            (state.o_ts, ramp_ts),
            (state.ol_valid, line_valid), (state.ol_i_id, batch.i_id),
            (state.ol_supply_w, batch.supply_w),
            (state.ol_qty, torch.where(line_valid, batch.qty, 0)),
            (state.ol_amount, amount), (state.ol_ts, ol_ts),
            (state.ol_vis, line_valid)):
        _put_rows(table, flat, vals, keep)


def order_line_valid(batch: NewOrderBatch) -> Tensor:
    """[B, L] bool: line l of order b exists (l < n_lines[b])."""
    L = batch.i_id.shape[1]
    line = torch.arange(L, dtype=torch.int32, device=batch.n_lines.device)
    return line[None, :] < batch.n_lines[:, None]


def _outbox(flat: FlatLines, ok: Tensor) -> StockDelta:
    rmask = ok & ~flat.local
    return StockDelta(dst_w=torch.where(rmask, flat.w, 0),
                      i_id=torch.where(rmask, flat.i, 0),
                      qty=torch.where(rmask, flat.q, 0), valid=rmask)


def _district_rank(batch: NewOrderBatch, D: int,
                   committed: Tensor | None = None) -> Tensor:
    """Each transaction's rank among the earlier (committed) transactions
    of its district in the batch: the batched increment-and-get, as the
    reference's ``[B, B]`` prefix-count matrix."""
    B = batch.w.shape[0]
    key = batch.w * D + batch.d
    before = (key[None, :] == key[:, None]) & torch.ones(
        (B, B), dtype=torch.bool, device=key.device).tril(-1)
    if committed is not None:
        before &= committed[None, :]
    return before.sum(1).to(torch.int32)


def _totals(state: TPCCState, batch: NewOrderBatch, wl: Tensor,
            amount: Tensor) -> Tensor:
    wl, d = wl.long(), batch.d.long()
    disc = state.c_discount[wl, d, batch.c.long()]
    tax = state.w_tax[wl] + state.d_tax[wl, d]
    return ref.sum_lines(amount) * (1.0 - disc) * (1.0 + tax)


def apply_neworder(state: TPCCState, batch: NewOrderBatch,
                   scale: TPCCScale, w_lo: int = 0, w_hi: int | None = None,
                   replica: int = 0, num_replicas: int = 1
                   ) -> tuple[TPCCState, StockDelta, Tensor]:
    """Coordination-avoiding New-Order (the merge regime): a batched
    per-district increment-and-get for o_ids, FK inserts, local stock
    updates with restock, remote lines emitted as the outbox, and RAMP
    stamps ``ts * num_replicas + replica`` on the whole write set.

    Returns (state, remote outbox, per-txn total amounts).
    """
    w_hi = scale.n_warehouses if w_hi is None else w_hi
    ramp_ts = batch.ts * num_replicas + replica
    wl = batch.w - w_lo
    idx = (wl.long(), batch.d.long())

    rank = _district_rank(batch, scale.districts)
    o_id = state.d_next_o_id[idx] + rank
    state.d_next_o_id.index_put_(idx, torch.ones_like(rank), accumulate=True)

    line_valid = order_line_valid(batch)
    price = state.i_price[idx[0][:, None], batch.i_id.long()]
    amount = torch.where(line_valid, price * batch.qty.to(price.dtype), 0.0)
    _insert_order_rows(state, batch, scale, wl, o_id, None, line_valid,
                       ramp_ts, amount,
                       torch.where(line_valid, ramp_ts[:, None], -1))

    flat = flatten_order_lines(batch, w_lo, w_hi)
    flat_valid = line_valid.reshape(-1)
    apply_stock_updates(state, flat.w - w_lo, flat.i, flat.q,
                        flat_valid & flat.local, flat.remote)
    return state, _outbox(flat, flat_valid), _totals(state, batch, wl, amount)


# ---------------------------------------------------------------------------
# Escrowed strict-stock New-Order (paper §8: amortizing coordination)
# ---------------------------------------------------------------------------


def escrow_share_for(s_quantity, replica, num_replicas: int, alive=None):
    """Replica ``replica``'s share of every stock cell — THE partition
    formula: ``q // R`` each, the remainder to the lowest slots. ``alive``
    ([R] mask) gives dead replicas ZERO and partitions among the live ones;
    the sum over slots equals ``q`` either way."""
    q = torch.as_tensor(s_quantity).to(torch.int32)
    r = torch.as_tensor(replica, dtype=torch.int32, device=q.device)
    if alive is None:
        return q // num_replicas + (r < q % num_replicas).to(torch.int32)
    alive_i = torch.as_tensor(alive, device=q.device).to(torch.int32)
    n_live = alive_i.sum().clamp_min(1).to(torch.int32)
    rank = (torch.cumsum(alive_i, 0).to(torch.int32) - 1)[r.long()]
    share = q // n_live + (rank < q % n_live).to(torch.int32)
    return alive_i[r.long()] * share


def make_escrow_shares(s_quantity, num_replicas: int) -> Tensor:
    """Partition every stock cell's quantity into per-replica shares: an
    int32 ``[R, W, I]`` tensor with ``shares.sum(0) == s_quantity``
    exactly (the dense layout's ``EscrowCounter`` shares)."""
    q = torch.as_tensor(s_quantity).to(torch.int32)
    slots = torch.arange(num_replicas, dtype=torch.int32,
                         device=q.device).reshape((num_replicas,)
                                                  + (1,) * q.dim())
    return escrow_share_for(q, slots, num_replicas)


ADMISSION_MODES = ("auto", "scan", "kernel")

# the "auto" fallback when the cut-over is not measured: below this batch
# the B-step scan, at or above it the gate + kernel
AUTO_KERNEL_MIN_BATCH = 64

# False pins "auto" to the constant threshold (no timing probe)
ADMISSION_AUTOTUNE = True

_CUTOVER_CACHE: dict[tuple, str] = {}


def resolve_admission_cutover(batch: int, n_lines: int = 15, *, device,
                              cells: int = 4096, trials: int = 3) -> str:
    """Time the scan against the gate + kernel pipeline once per (device
    type, batch shape) on a synthetic admission problem of that shape, on
    the device the program runs on, and memoize the faster one. A failure
    of either strategy raises; it is not hidden behind the constant."""
    dev = torch.device(device)
    key = (dev.type, batch, n_lines)
    hit = _CUTOVER_CACHE.get(key)
    if hit is not None:
        return hit
    rng = np.random.default_rng(0)
    # plentiful stock under a skewed access profile: the regime the engine
    # runs, where contention is the exception
    avail0 = torch.as_tensor(rng.integers(100, 500, size=cells),
                             dtype=torch.int32, device=dev)
    slot = torch.as_tensor(
        (cells * rng.power(4.0, size=(batch, n_lines))).astype(np.int64)
        % cells, dtype=torch.int32, device=dev)
    qty = torch.as_tensor(rng.integers(1, 10, size=(batch, n_lines)),
                          dtype=torch.int32, device=dev)
    lv = torch.as_tensor(rng.random((batch, n_lines)) < 0.8, device=dev)
    reps = max(trials, 1024 // max(batch, 1))
    walls = {}
    # each trial gets a fresh vector, as each batch does (the kernel
    # updates it in place)
    for mode in ("scan", "kernel"):
        admit_fcfs(avail0.clone(), slot, qty, lv, admission=mode)  # warm-up
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            admit_fcfs(avail0.clone(), slot, qty, lv, admission=mode)
        synchronize(dev)
        walls[mode] = time.perf_counter() - t0
    choice = min(walls, key=walls.get)
    _CUTOVER_CACHE[key] = choice
    return choice


def resolve_admission(admission: str, batch: int, n_lines: int | None = None,
                      device="cpu") -> str:
    """Resolve the ``admission=`` knob for a batch shape: "auto" asks the
    memoized timing probe (:func:`resolve_admission_cutover`) on
    ``device`` when the line width is known and autotuning is on, else the
    ``AUTO_KERNEL_MIN_BATCH`` constant."""
    if admission not in ADMISSION_MODES:
        raise ValueError(f"unknown admission {admission!r}; "
                         f"choose from {ADMISSION_MODES}")
    if admission == "auto":
        if n_lines is not None and ADMISSION_AUTOTUNE:
            return resolve_admission_cutover(batch, n_lines, device=device)
        return "kernel" if batch >= AUTO_KERNEL_MIN_BATCH else "scan"
    return admission


def admission_resolved(admission: str, batch: int, n_lines: int,
                       device) -> bool:
    """Whether :func:`resolve_admission` answers this shape without the
    timing probe (which synchronises, so no CUDA graph may capture it)."""
    if admission != "auto" or not ADMISSION_AUTOTUNE:
        return True
    return (torch.device(device).type, batch, n_lines) in _CUTOVER_CACHE


EFFECTS_MODES = ("scan", "fused")


def resolve_effects(effects: str) -> str:
    """Validate the ``effects=`` knob: "scan" is the per-phase path,
    "fused" the megastep, bit-identically."""
    if effects not in EFFECTS_MODES:
        raise ValueError(f"unknown effects {effects!r}; "
                         f"choose from {EFFECTS_MODES}")
    return effects


def admit_fcfs(avail0: Tensor, slot: Tensor, qty: Tensor, line_valid: Tensor,
               admission: str = "scan") -> tuple[Tensor, Tensor]:
    """FCFS admission of a batch against an availability vector; returns
    (committed [B] bool, avail [A] after all admitted reservations),
    bit-identical across strategies:

    * ``"scan"`` — the definitional sequential walk over the whole batch
      (``kernels/ref.escrow_admit_ref``);
    * ``"kernel"`` — the contention gate plus the residual FCFS walk
      (``kernels/ops.escrow_admit``: the CUDA kernel on the card, its plain
      version on the CPU);
    * ``"auto"`` — :func:`resolve_admission` picks per batch shape.

    On the card ``"kernel"`` updates ``avail0`` in place: pass a vector the
    caller no longer needs.
    """
    B, L = slot.shape
    if resolve_admission(admission, B, L, slot.device) == "kernel":
        return ops.escrow_admit(avail0, slot, qty, line_valid)
    return ref.escrow_admit_ref(avail0, slot, qty, line_valid)


def apply_neworder_escrow(state: TPCCState, shares: Tensor, spent: Tensor,
                          batch: NewOrderBatch, scale: TPCCScale,
                          w_lo: int = 0, w_hi: int | None = None,
                          replica: int = 0, num_replicas: int = 1,
                          admission: str = "scan", effects: str = "scan"
                          ) -> tuple[TPCCState, Tensor, StockDelta, Tensor,
                                     Tensor]:
    """Strict-stock New-Order over the dense escrow layout: every line
    spends this replica's share of its (warehouse, item) cell
    (``shares``/``spent`` are this replica's ``[W, I]`` slot, W the GLOBAL
    warehouse count). A transaction commits iff every valid line fits the
    remaining share (FCFS in batch order, duplicate cells included);
    otherwise it aborts with no effects. ``admission`` and ``effects`` pick
    strategies with bit-identical results.

    ``shares`` is read only before the state changes on the "scan" effects
    path, so a caller may pass ``state.s_quantity`` itself there.

    Returns (state, spent', remote outbox, totals, committed [B]).
    """
    w_hi = scale.n_warehouses if w_hi is None else w_hi
    ramp_ts = batch.ts * num_replicas + replica
    line_valid = order_line_valid(batch)
    # this replica's remaining share of every cell, flattened w-major
    avail0 = (shares - spent).reshape(-1)
    slot = batch.supply_w * scale.n_items + batch.i_id

    if resolve_effects(effects) == "fused":
        state, avail, delta, total, committed = _neworder_fused_effects(
            state, batch, scale, avail0, slot, line_valid, ramp_ts, w_lo,
            w_hi, admission)
        return state, shares - avail.reshape(shares.shape), delta, total, \
            committed

    committed, avail = admit_fcfs(avail0, slot, batch.qty, line_valid,
                                  admission)
    spent = shares - avail.reshape(shares.shape)
    state, delta, total = _neworder_committed_effects(
        state, batch, scale, committed, line_valid, ramp_ts, w_lo, w_hi)
    return state, spent, delta, total, committed


def _neworder_committed_effects(state: TPCCState, batch: NewOrderBatch,
                                scale: TPCCScale, committed: Tensor,
                                line_valid: Tensor, ramp_ts: Tensor,
                                w_lo: int, w_hi: int
                                ) -> tuple[TPCCState, StockDelta, Tensor]:
    """Committed-only strict-stock effects (the per-phase "scan" path):
    dense o_ids over committed txns, aborted rows dropped, restock-free
    stock decrements, remote lines as the outbox."""
    wl = batch.w - w_lo
    idx = (wl.long(), batch.d.long())
    line_ok = line_valid & committed[:, None]

    o_id = state.d_next_o_id[idx] + _district_rank(batch, scale.districts,
                                                   committed)
    state.d_next_o_id.index_put_(idx, committed.to(torch.int32),
                                 accumulate=True)

    price = state.i_price[idx[0][:, None], batch.i_id.long()]
    amount = torch.where(line_valid, price * batch.qty.to(price.dtype), 0.0)
    _insert_order_rows(state, batch, scale, wl, o_id, committed, line_valid,
                       ramp_ts, amount,
                       torch.where(line_valid, ramp_ts[:, None], -1))

    flat = flatten_order_lines(batch, w_lo, w_hi)
    flat_ok = line_ok.reshape(-1)
    apply_stock_updates(state, flat.w - w_lo, flat.i, flat.q,
                        flat_ok & flat.local, flat.remote, restock=False)
    total = torch.where(committed, _totals(state, batch, wl, amount), 0.0)
    return state, _outbox(flat, flat_ok), total


def megastep_args(state: TPCCState, batch: NewOrderBatch, scale: TPCCScale,
                  avail0: Tensor, slot: Tensor, line_valid: Tensor,
                  ramp_ts: Tensor, w_lo: int, w_hi: int
                  ) -> tuple[tuple[Tensor, ...], dict]:
    """The megastep problem of a batch: ``(args, kw)`` for
    ``kernels.ops.txn_megastep(*args, **kw)`` — the admission problem plus
    shard-local district keys, local stock cells, the local/remote line
    split, the RAMP stamps and the gathered price row."""
    B, L = batch.i_id.shape
    D, I = scale.districts, scale.n_items
    Wl = state.s_quantity.shape[0]
    wl = batch.w - w_lo
    flat = flatten_order_lines(batch, w_lo, w_hi)
    local_line = line_valid & flat.local.reshape(B, L)
    remote_line = flat.remote.reshape(B, L)
    key_local = (wl * D + batch.d).to(torch.int32)
    cell_local = torch.where(local_line, (batch.supply_w - w_lo) * I
                             + batch.i_id, 0).to(torch.int32)
    price = state.i_price[wl.long()[:, None], batch.i_id.long()]
    return ((avail0, slot, batch.qty, line_valid, key_local, cell_local,
             local_line, remote_line, ramp_ts, price),
            dict(n_keys=Wl * D, n_cells=Wl * I))


def _neworder_fused_effects(state: TPCCState, batch: NewOrderBatch,
                            scale: TPCCScale, avail0: Tensor, slot: Tensor,
                            line_valid: Tensor, ramp_ts: Tensor,
                            w_lo: int, w_hi: int, admission: str
                            ) -> tuple[TPCCState, Tensor, StockDelta, Tensor,
                                       Tensor]:
    """The FUSED strict-stock New-Order: admission, committed effects and
    RAMP stamps through the megastep (``kernels/ops.txn_megastep``), whose
    products land as dense adds (district counters, the four stock tables)
    and the order/order-line row inserts.

    Returns (state, settled avail, outbox, totals, committed).
    """
    B, L = batch.i_id.shape
    D, I = scale.districts, scale.n_items
    Wl = state.s_quantity.shape[0]
    wl = batch.w - w_lo
    args, kw = megastep_args(state, batch, scale, avail0, slot, line_valid,
                             ramp_ts, w_lo, w_hi)
    if resolve_admission(admission, B, L, slot.device) == "kernel":
        out = ops.txn_megastep(*args, **kw)
    else:
        # scan admission + the plain effect products: the products do not
        # depend on the admission strategy
        committed, avail = admit_fcfs(*args[:4], "scan")
        out = MegastepOut(committed, avail, *megastep_effect_products(
            committed, *args[2:], **kw))

    committed = out.committed
    o_id = state.d_next_o_id[wl.long(), batch.d.long()] + out.rank
    state.d_next_o_id.add_(out.d_count.reshape(Wl, D))
    _insert_order_rows(state, batch, scale, wl, o_id, committed, line_valid,
                       ramp_ts, out.amount, out.ol_ts)

    dec = out.stock_dec.reshape(Wl, I)
    state.s_quantity.sub_(dec)
    state.s_ytd.add_(dec.to(state.s_ytd.dtype))
    state.s_order_cnt.add_(out.stock_cnt.reshape(Wl, I))
    state.s_remote_cnt.add_(out.stock_rcnt.reshape(Wl, I))

    flat = flatten_order_lines(batch, w_lo, w_hi)
    line_ok = (line_valid & committed[:, None]).reshape(-1)
    total = torch.where(committed, _totals(state, batch, wl, out.amount), 0.0)
    return state, out.avail, _outbox(flat, line_ok), total, committed


# ---------------------------------------------------------------------------
# Sparse hot-set escrow (two-tier layout): escrow only the contended cells,
# owner-route the cold tail. Item popularity is Zipfian by id.
# ---------------------------------------------------------------------------


def item_popularity(n_items: int, theta: float) -> np.ndarray:
    """Zipfian access profile: item id == popularity rank,
    p(i) ∝ 1 / (i + 1)**theta. ``theta=0`` is uniform."""
    p = 1.0 / np.power(np.arange(1, n_items + 1, dtype=np.float64), theta)
    return p / p.sum()


def default_hot_items(scale: TPCCScale) -> int:
    """Default hot-set width: the top 1% of the item catalog (>= 1)."""
    return max(1, scale.n_items // 100)


def select_hot_cells(scale: TPCCScale, hot_items: int) -> np.ndarray:
    """The top-K contended (warehouse, item) cells as sorted int32 keys
    ``w * n_items + i``: the ``hot_items`` most popular ids crossed with
    every warehouse (w-major, ascending item: already sorted)."""
    hot_items = min(max(1, hot_items), scale.n_items)
    w = np.arange(scale.n_warehouses, dtype=np.int64)[:, None]
    i = np.arange(hot_items, dtype=np.int64)[None, :]
    keys = (w * scale.n_items + i).reshape(-1)
    if keys[-1] > np.iinfo(np.int32).max:
        raise ValueError("cell key overflows int32")
    return keys.astype(np.int32)


def escrow_layout_bytes(scale: TPCCScale, hot_items: int) -> dict:
    """Per-device escrow residency of the two layouts (int32 everywhere):
    dense — ``[1, W, I]`` shares + spent; sparse — the ``[K]`` key table
    plus ``[1, K]`` shares + spent, K = W * hot_items."""
    dense = 2 * scale.n_warehouses * scale.n_items * 4
    K = scale.n_warehouses * min(max(1, hot_items), scale.n_items)
    sparse = 3 * K * 4
    return {"dense_bytes_per_device": dense,
            "sparse_bytes_per_device": sparse,
            "hot_cells": K,
            "reduction_vs_dense": dense / sparse}


def sparse_admission_problem(s_quantity: Tensor, hot_keys: Tensor,
                             hot_headroom: Tensor, supply_w: Tensor,
                             i_id: Tensor, n_items: int, w_lo: int,
                             w_hi: int) -> tuple[Tensor, Tensor]:
    """The two-tier layout's admission problem: ONE availability vector

      [0, K)            hot-cell headroom (shares - spent, this replica)
      [K, K + Wl*I)     cold LOCAL stock (this shard's s_quantity)
      [K + Wl*I]        sentinel BIG for cold REMOTE lines, admitted
                        optimistically and settled at their owner

    and the per-line slots into it. Returns (avail0, slot)."""
    K = hot_keys.shape[0]
    Wl = s_quantity.shape[0]
    pos, is_hot = hot_position(hot_keys, supply_w * n_items + i_id)
    is_local = (supply_w >= w_lo) & (supply_w < w_hi)
    wl_line = torch.where(is_local, supply_w - w_lo, 0)
    big = torch.full((1,), np.iinfo(np.int32).max // 2, dtype=torch.int32,
                     device=s_quantity.device)
    avail0 = torch.cat([hot_headroom, s_quantity.reshape(-1), big])
    slot = torch.where(is_hot, pos,
                       torch.where(is_local, K + wl_line * n_items + i_id,
                                   K + Wl * n_items)).to(torch.int32)
    return avail0, slot


def apply_neworder_escrow_sparse(state: TPCCState, hot_keys: Tensor,
                                 hot_shares: Tensor, hot_spent: Tensor,
                                 batch: NewOrderBatch, scale: TPCCScale,
                                 w_lo: int = 0, w_hi: int | None = None,
                                 replica: int = 0, num_replicas: int = 1,
                                 admission: str = "scan",
                                 effects: str = "scan"
                                 ) -> tuple[TPCCState, Tensor, StockDelta,
                                            Tensor, Tensor]:
    """Strict-stock New-Order over the two-tier escrow layout: HOT lines
    spend this replica's share, COLD local lines reserve the shard's own
    stock, COLD remote lines ride the sentinel and settle at their owner
    (:func:`apply_stock_updates_strict_tiered`). ``admission`` and
    ``effects`` pick strategies with bit-identical results.

    Returns (state, hot_spent', remote outbox, totals, committed [B]).
    """
    w_hi = scale.n_warehouses if w_hi is None else w_hi
    ramp_ts = batch.ts * num_replicas + replica
    K = hot_keys.shape[0]
    line_valid = order_line_valid(batch)
    avail0, slot = sparse_admission_problem(
        state.s_quantity, hot_keys, hot_shares - hot_spent, batch.supply_w,
        batch.i_id, scale.n_items, w_lo, w_hi)

    if resolve_effects(effects) == "fused":
        state, avail, delta, total, committed = _neworder_fused_effects(
            state, batch, scale, avail0, slot, line_valid, ramp_ts, w_lo,
            w_hi, admission)
        return state, hot_shares - avail[:K], delta, total, committed

    committed, avail = admit_fcfs(avail0, slot, batch.qty, line_valid,
                                  admission)
    state, delta, total = _neworder_committed_effects(
        state, batch, scale, committed, line_valid, ramp_ts, w_lo, w_hi)
    return state, hot_shares - avail[:K], delta, total, committed


def apply_stock_updates_strict_tiered(state: TPCCState, hot_keys: Tensor,
                                      dst_w: Tensor, i_idx: Tensor,
                                      qty: Tensor, mask: Tensor,
                                      remote: Tensor, n_items: int,
                                      w_lo: int = 0
                                      ) -> tuple[TPCCState, Tensor]:
    """Owner-side strict apply of drained outbox entries, split by tier:
    HOT entries (share-admitted upstream) apply unconditionally; COLD
    entries land per cell ALL-OR-NOTHING — a cell's queued entries apply
    iff their total fits its stock, which depends only on the per-cell
    total and so not on entry order. Returns (state, rejected count int32).
    """
    _, is_hot = hot_position(hot_keys, dst_w * n_items + i_idx)
    w_idx = torch.where(mask, dst_w - w_lo, 0)
    i_idx = torch.where(mask, i_idx, 0)
    cold = mask & ~is_hot
    admit_cold = _cold_fits(state.s_quantity, w_idx, i_idx, qty, cold)
    rejects = (cold & ~admit_cold).sum().to(torch.int32)
    state = apply_stock_updates(state, w_idx, i_idx, qty,
                                (mask & is_hot) | admit_cold, remote,
                                restock=False)
    return state, rejects


class RetryState(NamedTuple):
    """Bounded retry ring of one owner shard for its rejected remote-cold
    outbox entries: ``C`` lanes, ``valid`` marks the live ones. Every entry
    is a cold cell this owner holds (its own drain rejected it), so
    re-presenting it needs no routing and no collective. ``tries`` counts
    the drain windows it has lost; at ``retry_max`` it becomes a FINAL
    reject. ``reserved`` marks an owner-granted reservation: its stock is
    already debited, and the next drain frees the lane as applied."""

    dst_w: Tensor     # [C] int32 GLOBAL destination warehouse
    i_id: Tensor      # [C] int32
    qty: Tensor       # [C] int32
    tries: Tensor     # [C] int32 drain windows already lost
    valid: Tensor     # [C] bool
    reserved: Tensor  # [C] bool


def empty_retry(capacity: int, device=None) -> RetryState:
    dev = resolve_device(device)
    i32 = lambda: torch.zeros((capacity,), dtype=torch.int32, device=dev)
    b = lambda: torch.zeros((capacity,), dtype=torch.bool, device=dev)
    return RetryState(i32(), i32(), i32(), i32(), b(), b())


_INT32_MAX = torch.iinfo(torch.int32).max


def _lexsort(keys: tuple[Tensor, ...]) -> Tensor:
    """``jnp.lexsort``: the permutation sorting by the LAST key, ties by
    the one before, and so on, full ties in index order (stable sorts,
    least significant key first)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _greedy_admit(cell: Tensor, qty: Tensor, live: Tensor, order: Tensor,
                  s_quantity: Tensor, dst_w: Tensor, i_id: Tensor,
                  w_lo: int) -> Tensor:
    """Per-cell greedy admission in ``order``: a live lane is admitted
    while its cell's cumulative demand (every live lane sorted before it,
    itself included) fits the cell's stock. Returns the mask in lane
    order."""
    c_s = cell[order]
    q_s = torch.where(live, qty, 0)[order]
    v_s = live[order]
    csum = torch.cumsum(q_s, 0, dtype=torch.int32)
    seg_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                      device=c_s.device),
                           c_s[1:] != c_s[:-1]])
    # the cumulative demand within each cell's segment: csum minus the
    # running total at the segment's start (csum is non-decreasing, so
    # cummax recovers it)
    prefix = csum - torch.cummax(torch.where(seg_start, csum - q_s, 0),
                                 0).values
    stock_s = s_quantity[torch.where(v_s, dst_w[order] - w_lo, 0).long(),
                         torch.where(v_s, i_id[order], 0).long()]
    admit = torch.zeros_like(live)
    admit[order] = v_s & (prefix <= stock_s)
    return admit


def apply_stock_updates_strict_tiered_retry(
        state: TPCCState, hot_keys: Tensor, dst_w: Tensor, i_idx: Tensor,
        qty: Tensor, mask: Tensor, remote: Tensor, retry: RetryState,
        n_items: int, w_lo: int = 0, retry_max: Tensor | int = 0,
        reserve: Tensor | int = 0
        ) -> tuple[TPCCState, RetryState, Tensor]:
    """:func:`apply_stock_updates_strict_tiered` with this owner's bounded
    retry ring, in four passes; each reads the stock the one before left:

    0. complete last window's reservations: free their lanes (their stock
       was debited at grant time, so they count as applied);
    1. re-present the ring, per cell GREEDY-BY-AGE: lanes sorted by (cell,
       tries descending, qty ascending) are admitted while the cell's
       cumulative demand fits its stock. The prefix counts rejected lanes
       too, so a big lane that never fits blocks the smaller ones behind
       it (the head-of-line blocking that reservations bound);
    2. the fresh window exactly as the non-retry drain (per-cell
       all-or-nothing);
    3. with ``reserve`` > 0, ring losers whose next loss would be final bid
       for the leftover stock, per cell smallest first; a grant debits the
       stock now and rides the ring one more window flagged ``reserved``.

    A ring loser that has now lost ``retry_max`` windows is a FINAL
    reject; a fresh cold reject enqueues with ``tries`` 0 (or is final at
    once when ``retry_max`` is 0). Survivors compact ring-first into the
    ``[C]`` ring; overflow beyond ``C`` is a final reject, not a silent
    drop. ``retry_max`` and ``reserve`` are ints or 0-d tensors, and
    nothing is read back to the host. With ``retry_max=0``, ``reserve=0``
    and an empty ring this is the non-retry drain bit for bit. Returns
    (state, retry', final-reject count int32).
    """
    C = retry.valid.shape[0]
    sq = state.s_quantity

    # -- pass 0: complete the reservations granted last window
    done = retry.valid & retry.reserved & (reserve > 0)
    r_valid = retry.valid & ~done

    # -- pass 1: the ring (cold cells owned here), greedy by age
    r_w = torch.where(r_valid, retry.dst_w - w_lo, 0)
    r_i = torch.where(r_valid, retry.i_id, 0)
    cell = retry.dst_w * n_items + retry.i_id
    r_cell = torch.where(r_valid, cell, _INT32_MAX)      # invalid sort last
    r_admit = _greedy_admit(
        r_cell, retry.qty, r_valid,
        _lexsort((retry.qty, -retry.tries, r_cell)), sq, retry.dst_w,
        retry.i_id, w_lo)
    apply_stock_updates(state, r_w, r_i, retry.qty, r_admit,
                        torch.ones_like(r_admit), restock=False)
    r_rej = r_valid & ~r_admit
    r_tries = retry.tries + 1
    r_final = r_rej & (r_tries >= retry_max)
    r_requeue = r_rej & (r_tries < retry_max)

    # -- pass 2: the fresh window against the stock pass 1 left
    _, is_hot = hot_position(hot_keys, dst_w * n_items + i_idx)
    w_idx = torch.where(mask, dst_w - w_lo, 0)
    i_l = torch.where(mask, i_idx, 0)
    cold = mask & ~is_hot
    admit_cold = _cold_fits(sq, w_idx, i_l, qty, cold)
    apply_stock_updates(state, w_idx, i_l, qty, (mask & is_hot) | admit_cold,
                        remote, restock=False)
    f_rej = cold & ~admit_cold
    f_requeue = f_rej & (retry_max > 0)
    f_final = f_rej & (retry_max <= 0)

    # -- pass 3: last-chance ring losers bid for the leftover stock
    last_chance = r_requeue & (r_tries >= retry_max - 1) & (reserve > 0)
    g_cell = torch.where(last_chance, cell, _INT32_MAX)
    granted = _greedy_admit(g_cell, retry.qty, last_chance,
                            _lexsort((retry.qty, g_cell)), sq, retry.dst_w,
                            retry.i_id, w_lo)
    apply_stock_updates(state, r_w, r_i, retry.qty, granted,
                        torch.ones_like(granted), restock=False)

    # -- compact the survivors ring-first into the [C] ring, through a
    # [C + 1] buffer whose slot C takes every dropped entry
    cand_keep = torch.cat([r_requeue, f_requeue])
    rank = torch.cumsum(cand_keep, 0, dtype=torch.int32) - 1
    keep = cand_keep & (rank < C)
    overflow = cand_keep & (rank >= C)
    slot = torch.where(keep, rank, C).long()

    def pack(ring_vals, fresh_vals):
        vals = torch.cat([ring_vals, fresh_vals])
        buf = torch.zeros((C + 1,), dtype=vals.dtype, device=vals.device)
        buf[slot] = torch.where(keep, vals, torch.zeros_like(vals))
        return buf[:C]

    new = RetryState(pack(retry.dst_w, dst_w), pack(retry.i_id, i_idx),
                     pack(retry.qty, qty),
                     pack(r_tries, torch.zeros_like(dst_w)),
                     pack(r_requeue, f_requeue),
                     pack(granted, torch.zeros_like(mask)))
    final = (r_final.sum() + f_final.sum() + overflow.sum()).to(torch.int32)
    return state, new, final


# ---------------------------------------------------------------------------
# Payment & Delivery ("largely uninteresting" per §6.2 — but implemented)
# ---------------------------------------------------------------------------


def payment_rounds(w: Tensor) -> int:
    """The chaining rounds Payment's ordered adds need for batches of home
    warehouses ``w`` (``[..., B]``, one batch a row): the most adds one
    warehouse of one batch takes, less one. The (w, d) and (w, d, c) keys
    repeat no more often than w does, so this covers all three of
    :func:`apply_payment`'s adds. One host read."""
    if w.numel() == 0:
        return 0
    rows = w.reshape(-1, w.shape[-1]).cpu().numpy()
    return max(int(np.bincount(r).max()) for r in rows) - 1


def _add_in_batch_order(tables: tuple[Tensor, ...], idx: tuple[Tensor, ...],
                        vals: tuple[Tensor, ...],
                        rounds: int | None = None) -> None:
    """``table[idx[b]] += val[b]`` for each table, in batch order: the adds
    that land on one cell land one after another, ``((v + a0) + a1) + ..``,
    which is how XLA's scatter-add runs on the CPU. Float adds do not
    associate, and torch's ``index_put_(accumulate=True)`` sums duplicate
    indices otherwise on the card, so the order is made explicit.

    Each add's running value chains from the previous add to the same cell,
    one round per duplicate depth; then every add writes its cell's final
    value, so duplicates write the same value and the scatter cannot race.
    ``rounds`` is the number of rounds; None reads the batch's deepest
    duplicate once on the host. More rounds than the batch needs change
    nothing (``depth == r`` matches no add), so a static count taken over a
    chunk of batches (:func:`payment_rounds`) gives the same floats and
    lets a CUDA graph capture the adds."""
    shape = tables[0].shape
    flat = torch.zeros_like(idx[0], dtype=torch.long)
    for i, n in zip(idx, shape):
        flat = flat * n + i.long()
    B = flat.shape[0]
    pos = torch.arange(B, device=flat.device)
    same = flat[None, :] == flat[:, None]
    before = same & (pos[None, :] < pos[:, None])
    prev = torch.where(before, pos[None, :], 0).amax(1)   # 0 when first
    last = torch.where(same, pos[None, :], 0).amax(1)
    depth = before.sum(1)
    if rounds is None:
        rounds = int(depth.max()) if B else 0
    for table, val in zip(tables, vals):
        view = table.view(-1)
        run = view[flat] + val
        for r in range(1, rounds + 1):
            run = torch.where(depth == r, run[prev] + val, run)
        view.index_put_((flat,), run[last])


def apply_payment(state: TPCCState, batch: PaymentBatch,
                  w_lo: int = 0, rounds: int | None = None) -> TPCCState:
    """Payment: commutative counter increments (I-confluent, Table 2), each
    landing in batch order (:func:`_add_in_batch_order`; ``rounds`` as
    there, at least :func:`payment_rounds` of the batch)."""
    w, d, c = batch.w - w_lo, batch.d, batch.c
    amt = batch.amount
    _add_in_batch_order((state.w_ytd,), (w,), (amt,), rounds)
    _add_in_batch_order((state.d_ytd, state.h_amount_sum), (w, d),
                        (amt, amt), rounds)
    _add_in_batch_order((state.c_balance, state.c_ytd_payment), (w, d, c),
                        (-amt, amt), rounds)
    state.c_payment_cnt.index_put_((w.long(), d.long(), c.long()),
                                   torch.ones_like(c), accumulate=True)
    return state


def apply_delivery(state: TPCCState, carrier_id, ts) -> TPCCState:
    """Deliver the oldest undelivered order in every district (single-
    partition, as the spec permits and the paper notes). ``ts`` is unused,
    as in the reference.

    The credited amount is read through the RAMP prepared layer
    (``ol_valid`` and a matching stamp), never the possibly lagging visible
    layer, so it covers the complete write set, and is summed in line
    order. Every ``(w, d)`` names one slot and one customer, so the
    writes below have no duplicate index."""
    W, D, OC = state.no_valid.shape
    dev = state.no_valid.device
    key = torch.where(state.no_valid, state.o_entry_d,
                      torch.iinfo(torch.int32).max)
    slot = key.argmin(2)                                  # [W, D]
    has = state.no_valid.any(2)                           # [W, D]
    wI = torch.arange(W, device=dev)[:, None].expand(W, D)
    dI = torch.arange(D, device=dev)[None, :].expand(W, D)
    at = (wI, dI, slot)

    cust = state.o_c_id[at].long()
    line_ok = state.ol_valid[at] & (state.ol_ts[at] == state.o_ts[at][..., None])
    lines_amt = torch.where(line_ok, state.ol_amount[at], 0.0)
    amt = ref.sum_lines(lines_amt) * has

    state.no_valid.index_put_(at, torch.where(has, False, state.no_valid[at]))
    state.o_carrier.index_put_(at, torch.where(
        has, carrier_id, state.o_carrier[at]).to(torch.int32))
    state.ol_delivered.index_put_(at, torch.where(
        has[..., None], state.ol_valid[at], state.ol_delivered[at]))
    cat = (wI, dI, cust)
    state.c_balance.index_put_(cat, state.c_balance[cat] + amt)
    state.c_delivered_sum.index_put_(cat, state.c_delivered_sum[cat] + amt)
    state.c_delivery_cnt.index_put_(cat, state.c_delivery_cnt[cat]
                                    + has.to(torch.int32))
    return state


# ---------------------------------------------------------------------------
# The twelve consistency criteria (TPC-C §3.3.2.1-12), executable
# ---------------------------------------------------------------------------


def check_consistency(state, atol: float = 1e-2) -> dict[int, bool]:
    """Evaluate all twelve criteria on a (converged) state, on the host.
    ``state`` may be a torch state or one already copied to numpy."""
    from repro_torch.convert import state_to_numpy

    s = state_to_numpy(state)
    out = {}
    out[1] = bool(np.allclose(s.w_ytd, s.d_ytd.sum(-1), atol=atol))
    order_count = s.o_valid.sum(-1)
    out[2] = bool(np.array_equal(s.d_next_o_id, order_count))
    no_count = s.no_valid.sum(-1)
    delivered = (s.o_valid & ~s.no_valid).sum(-1)
    out[3] = bool(np.array_equal(no_count + delivered, order_count))
    out[4] = bool(np.array_equal(
        np.where(s.o_valid, s.o_ol_cnt, 0).sum(-1), s.ol_valid.sum((-1, -2))))
    out[5] = bool(np.all((s.o_carrier < 0) == s.no_valid | ~s.o_valid))
    out[6] = bool(np.all(np.where(s.o_valid, s.o_ol_cnt, 0)
                         == s.ol_valid.sum(-1)))
    deliv_order = s.o_valid & (s.o_carrier >= 0)
    out[7] = bool(np.all(s.ol_delivered ==
                         (s.ol_valid & deliv_order[..., None])))
    out[8] = bool(np.allclose(s.w_ytd, s.h_amount_sum.sum(-1), atol=atol))
    out[9] = bool(np.allclose(s.d_ytd, s.h_amount_sum, atol=atol))
    out[10] = bool(np.allclose(s.c_balance,
                               s.c_delivered_sum - s.c_ytd_payment, atol=atol))
    out[11] = bool(np.array_equal(order_count - no_count, delivered))
    out[12] = bool(np.allclose(s.c_balance + s.c_ytd_payment,
                               s.c_delivered_sum, atol=atol))
    return out


def tpcc_invariants() -> list[tuple[int, Invariant, bool]]:
    """The twelve criteria as analyzer objects with the paper's grouping:
    foreign-key style (4-7, 11) and materialized counters (1, 8-10, 12)
    are I-confluent; sequential ID assignment (2-3) is not.

    Returns (criterion number, invariant, expected confluent?).
    """
    fk = InvariantKind.FOREIGN_KEY
    mv = InvariantKind.MATERIALIZED_VIEW
    seq = InvariantKind.AUTO_INCREMENT
    return [
        (1, Invariant("w_ytd_sums_d_ytd", mv, "warehouse.w_ytd",
                      params={"source": "district.d_ytd"}), True),
        (2, Invariant("d_next_o_id_sequential", seq, "district.d_next_o_id"), False),
        (3, Invariant("no_o_id_contiguous", seq, "new_order.o_id"), False),
        (4, Invariant("ol_count_matches_o_ol_cnt", fk, "order_line.o_id",
                      params={"references": "order.o_id"}), True),
        (5, Invariant("carrier_null_iff_new_order", fk, "order.carrier",
                      params={"references": "new_order.o_id"}), True),
        (6, Invariant("o_ol_cnt_per_order", fk, "order.o_ol_cnt",
                      params={"references": "order_line.o_id"}), True),
        (7, Invariant("ol_delivery_iff_carrier", fk, "order_line.delivery_d",
                      params={"references": "order.carrier"}), True),
        (8, Invariant("w_ytd_sums_history", mv, "warehouse.w_ytd",
                      params={"source": "history.h_amount"}), True),
        (9, Invariant("d_ytd_sums_history", mv, "district.d_ytd",
                      params={"source": "history.h_amount"}), True),
        (10, Invariant("c_balance_materialized", mv, "customer.c_balance",
                       params={"source": "order_line.ol_amount"}), True),
        (11, Invariant("order_minus_neworder_delivered", fk, "order.o_id",
                       params={"references": "new_order.o_id"}), True),
        (12, Invariant("c_balance_plus_ytd", mv, "customer.c_balance",
                       params={"source": "order_line.ol_amount"}), True),
    ]


# ---------------------------------------------------------------------------
# TPC-C as a planner state tree: core/planner.plan() over these specs
# selects the engine's regime per state element.
# ---------------------------------------------------------------------------


STOCK_INVARIANTS = ("restock", "strict", "serial")


def tpcc_state_specs(stock_invariant: str = "restock"):
    """TPC-C state elements as planner StateSpec declarations.
    ``stock_invariant`` is the application's declaration for
    STOCK.S_QUANTITY: "restock" (spec +91 rule, no floor) -> FREE,
    "strict" (``s_quantity >= 0``, no restock) -> ESCROW, "serial" (an
    opaque serializability demand) -> REQUIRED."""
    from repro_torch.core.planner import StateSpec
    from repro_torch.core.txn import Op, OpKind

    def inv(name, kind, target, params=None):
        return Invariant(name, kind, target, None, params or {})

    fk = InvariantKind.FOREIGN_KEY
    mv = InvariantKind.MATERIALIZED_VIEW

    if stock_invariant == "restock":
        stock_spec = StateSpec(
            "stock.s_quantity", "pncounter",
            (Op(OpKind.DECREMENT, "stock.s_quantity"),
             Op(OpKind.INCREMENT, "stock.s_quantity")),
            (),
            merge_every=0,
            note="spec restock rule: decrement-then-+91 keeps one residue "
                 "window; no floor invariant -> commutative counter")
    elif stock_invariant == "strict":
        stock_spec = StateSpec(
            "stock.s_quantity", "escrow",
            (Op(OpKind.DECREMENT, "stock.s_quantity"),),
            (inv("s_quantity_nonneg", InvariantKind.GREATER_THAN,
                 "stock.s_quantity", {"threshold": -1}),),
            merge_every=0,
            note="hard s_quantity >= 0 floor, no restock: concurrent "
                 "decrements can jointly cross it -> escrow shares (§8)")
    elif stock_invariant == "serial":
        stock_spec = StateSpec(
            "stock.s_quantity", "lww",
            (Op(OpKind.DECREMENT, "stock.s_quantity"),),
            (inv("s_quantity_serializable", InvariantKind.CUSTOM,
                 "stock.s_quantity",
                 {"semantics": "globally ordered exact stock"}),),
            merge_every=1,
            note="opaque serializability demand: no local rule -> "
                 "synchronous coordination (2PC fallback)")
    else:
        raise ValueError(f"unknown stock_invariant {stock_invariant!r}; "
                         f"choose from {STOCK_INVARIANTS}")

    return [
        StateSpec(
            "warehouse.w_ytd", "sum",
            (Op(OpKind.INCREMENT, "warehouse.w_ytd"),),
            (inv("w_ytd_sums_history", mv, "warehouse.w_ytd",
                 {"source": "history.h_amount"}),),
            merge_every=0,
            note="criteria 1/8: materialized payment sums, commutative"),
        StateSpec(
            "district.d_ytd", "sum",
            (Op(OpKind.INCREMENT, "district.d_ytd"),),
            (inv("d_ytd_sums_history", mv, "district.d_ytd",
                 {"source": "history.h_amount"}),),
            merge_every=0),
        StateSpec(
            "district.d_next_o_id", "max",
            (Op(OpKind.INSERT, "district.d_next_o_id"),),
            (inv("d_next_o_id_sequential", InvariantKind.AUTO_INCREMENT,
                 "district.d_next_o_id"),),
            merge_every=0,
            note="criteria 2/3: dense sequential o_ids — deferred "
                 "commit-time assignment by the district's owning shard "
                 "(the batched increment-and-get in apply_neworder)"),
        StateSpec(
            "order.rows", "versioned",
            (Op(OpKind.INSERT, "order.rows"),),
            (inv("ol_count_matches_o_ol_cnt", fk, "order_line.o_id",
                 {"references": "order.rows"}),),
            merge_every=0,
            note="criteria 4/6: FK inserts, I-confluent"),
        StateSpec(
            "new_order.rows", "2pset",
            (Op(OpKind.INSERT, "new_order.rows"),
             Op(OpKind.CASCADING_DELETE, "new_order.rows")),
            (inv("carrier_null_iff_new_order", fk, "order.carrier",
                 {"references": "new_order.rows"}),),
            merge_every=0,
            note="criteria 5/11: Delivery's removal is a cascading "
                 "tombstone, monotone under merge"),
        StateSpec(
            "order_line.rows", "versioned",
            (Op(OpKind.INSERT, "order_line.rows"),),
            (inv("ol_delivery_iff_carrier", fk, "order_line.rows",
                 {"references": "order.carrier"}),),
            merge_every=0),
        StateSpec(
            "customer.c_balance", "sum",
            (Op(OpKind.INCREMENT, "customer.c_balance"),
             Op(OpKind.DECREMENT, "customer.c_balance")),
            (inv("c_balance_materialized", mv, "customer.c_balance",
                 {"source": "order_line.ol_amount"}),),
            merge_every=0,
            note="criteria 10/12: balance is a materialized view of "
                 "payments and delivered order-lines"),
        StateSpec(
            "stock.s_ytd", "sum",
            (Op(OpKind.INCREMENT, "stock.s_ytd"),),
            (inv("s_ytd_materialized", mv, "stock.s_ytd",
                 {"source": "order_line.ol_qty"}),),
            merge_every=0),
        stock_spec,
    ]
