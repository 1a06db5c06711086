"""The plain reference of one TPC-C pass, in NumPy.

It replays a pass from the initial tables (a host copy of the tables the
benchmark built, with the spec's initial orders) and the pass's stream
(the benchmark's own inputs, ``portbench/frozen/tpcc_inputs.py``) with the
semantics the port implements, written out directly: New-Order in the
merge regime (the spec's restock rule) or under the strict
``s_quantity >= 0`` floor with the two-tier escrow (hot cells admitted
against the replica's share, cold local cells against the stock, first
come first served), Payment, the RAMP Order-Status and Stock-Level reads,
Delivery, and after every chunk the drain (and in the escrow regime the
share refresh). It imports nothing of the program and takes nothing it
made: hot keys, shares, o_ids, amounts and counters are worked out here
again.

The warehouses lie in ``n_shards`` (R) shards, shard r holding the block
``[r * W / R, (r + 1) * W / R)``. A New-Order's rows are stamped
``ts * R + r`` by its home shard r (the RAMP stamp). A line whose supply
warehouse is in the home shard is local: it applies at once, with the
batch's other local lines, and the restock rule follows on the cells it
touched. Every other committed line goes to the outbox; at the chunk's
drain each owner adds its entries (``s_remote_cnt`` + 1 each) and then
restocks. At R = 1 every line is local and the drain applies nothing.
The escrow regime covers R = 1 alone: at R > 1 it would need each
replica's share, admission against it and the cross-replica refresh.

``precision="bfloat16"`` rounds every float result to bfloat16 (the
control that must come out as not correct).

A district's order ``o_id`` sits at ring slot ``o_id``: the pass never
wraps the ring (``written_slots`` checks it), so the order columns are
kept for the slots the pass can reach, ``written_slots`` of them, and
every slot past them keeps its initial value.
"""

from __future__ import annotations

import dataclasses

import numpy as np

COUNTERS = ("neworders", "payments", "order_statuses", "stock_levels",
            "deliveries", "reads_found", "fractures_observed",
            "lines_repaired", "aborts", "cold_rejects")

STOCK_LEVEL_ORDERS = 20   # TPC-C clause 2.8.2.2: the district's last 20


def _bf16(x):
    """Round float32 values to bfloat16 (to nearest, ties to even), kept
    as float32."""
    a = np.asarray(x, dtype=np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).reshape(a.shape)


@dataclasses.dataclass
class PassResult:
    tables: dict            # column -> array (order columns [W, D, S, ...])
    counters: dict          # COUNTERS -> int, for the pass
    shares: np.ndarray | None   # [1, K] after the pass (escrow)
    spent: np.ndarray | None    # [1, K]
    read_lines: list   # per Order-Status batch: (rows, needed, matched,
    #                    matched but invisible, returned) lines
    drained: int = 0   # cross-shard lines the drains applied


def written_slots(d_next_o_id, stream, order_capacity: int) -> int:
    """S: the ring slots a pass's orders can reach, the most any district
    reaches when every New-Order commits."""
    nxt = np.asarray(d_next_o_id, np.int64).copy()
    for b in stream.neworder:
        np.add.at(nxt, (b["w"], b["d"]), 1)
    S = max(1, int(nxt.max()))
    if S > order_capacity:
        raise ValueError(f"a district reaches o_id {S} in a pass, past its "
                         f"ring of {order_capacity}")
    return S


def replay(initial: dict, stream, *, order_capacity: int, regime: str,
           hot_items: int | None, merge_every: int, refresh_every: int,
           deliveries: bool, precision: str = "float32",
           n_shards: int = 1) -> PassResult:
    """Replay one pass from ``initial`` (column -> array, the order
    columns cut to ``written_slots``) over ``n_shards`` warehouse shards;
    ``regime`` is "merge" or "escrow" (sparse layout over the
    ``hot_items`` most popular ids, one shard)."""
    OC = order_capacity
    rnd = _bf16 if precision == "bfloat16" else (
        lambda x: np.asarray(x, dtype=np.float32))
    t = {k: np.array(v) for k, v in initial.items()}
    W, D, C = t["c_balance"].shape
    I = t["s_quantity"].shape[1]
    L = t["ol_valid"].shape[3]
    f32, i32 = np.float32, np.int32
    R = n_shards
    if W % R:
        raise ValueError(f"{W} warehouses do not divide into {R} shards")
    Wps = W // R

    # a customer's latest order: the highest o_id among its valid orders
    last_order = np.full((W, D, C), -1, np.int64)
    wv, dv, sv = np.nonzero(t["o_valid"])
    np.maximum.at(last_order, (wv, dv, t["o_c_id"][wv, dv, sv]), sv)

    escrow = regime == "escrow"
    if escrow and R > 1:
        raise ValueError("the escrow regime's reference covers one shard: "
                         "per-replica shares are not modelled")
    # the chunk's cross-shard lines: (supply warehouse, item, quantity)
    outbox: list = []
    drained = 0
    if escrow:
        # the hot set: the hot_items most popular ids (popularity is by id)
        # crossed with every warehouse, w-major
        hot_i = min(max(1, hot_items), I)
        keys = (np.arange(W, dtype=np.int64)[:, None] * I
                + np.arange(hot_i, dtype=np.int64)[None, :]).reshape(-1)
        shares = t["s_quantity"].reshape(-1)[keys].astype(i32)[None, :]
        spent = np.zeros_like(shares)
    cnt = dict.fromkeys(COUNTERS, 0)
    read_lines = []
    line = np.arange(L)

    def hot_pos(w, i):
        """Position in the hot table and membership of cells (w, i)."""
        key = w.astype(np.int64) * I + i
        pos = np.clip(np.searchsorted(keys, key), 0, len(keys) - 1)
        return pos, keys[pos] == key

    def admit(b, lv):
        """FCFS admission in batch order: a transaction commits iff each
        valid line's quantity, with its own earlier lines on the same
        cell, fits what is left of the cell; commits reserve."""
        B = len(b["w"])
        pos, hot = hot_pos(b["supply_w"], b["i_id"])
        avail = {}
        ok = np.zeros(B, bool)
        for x in range(B):
            need = {}
            for l in range(int(b["n_lines"][x])):
                cell = (bool(hot[x, l]), int(pos[x, l]) if hot[x, l] else
                        (int(b["supply_w"][x, l]), int(b["i_id"][x, l])))
                need[cell] = need.get(cell, 0) + int(b["qty"][x, l])
            fits = True
            for cell, q in need.items():
                if cell not in avail:
                    avail[cell] = (int(shares[0, cell[1]] - spent[0, cell[1]])
                                   if cell[0] else
                                   int(t["s_quantity"][cell[1]]))
                if q > avail[cell]:
                    fits = False
                    break
            if fits:
                for cell, q in need.items():
                    avail[cell] -= q
                ok[x] = True
        return ok, pos, hot

    def neworder(b):
        B = len(b["w"])
        w, d = b["w"], b["d"]
        lv = line[None, :] < b["n_lines"][:, None]
        if escrow:
            ok, pos, hot = admit(b, lv)
        else:
            ok = np.ones(B, bool)
        cnt["neworders"] += int(ok.sum())
        cnt["aborts"] += int(B - ok.sum())
        # each committed order's rank among the earlier committed orders of
        # its district in the batch
        key = w.astype(np.int64) * D + d
        rank = np.zeros(B, np.int64)
        seen: dict = {}
        for x in np.nonzero(ok)[0]:
            k = int(key[x])
            rank[x] = seen.get(k, 0)
            seen[k] = rank[x] + 1
        o_id = t["d_next_o_id"][w, d].astype(np.int64) + rank
        np.add.at(t["d_next_o_id"], (w, d), ok.astype(i32))
        c = np.nonzero(ok)[0]
        wc, dc, oc = w[c], d[c], o_id[c]
        lvc = lv[c]
        amount = np.where(lvc, rnd(t["i_price"][wc[:, None], b["i_id"][c]]
                                   * b["qty"][c].astype(f32)), f32(0))
        home = w[c] // Wps
        ts = b["ts"][c] * R + home           # the RAMP stamp of shard home
        at = (wc, dc, oc)
        t["o_valid"][at] = True
        t["o_c_id"][at] = b["c"][c]
        t["o_ol_cnt"][at] = b["n_lines"][c]
        t["o_carrier"][at] = -1
        t["o_entry_d"][at] = b["ts"][c]
        t["no_valid"][at] = True
        t["o_ts"][at] = ts
        t["ol_valid"][at] = lvc
        t["ol_i_id"][at] = b["i_id"][c]
        t["ol_supply_w"][at] = b["supply_w"][c]
        t["ol_qty"][at] = np.where(lvc, b["qty"][c], 0)
        t["ol_amount"][at] = amount
        t["ol_ts"][at] = np.where(lvc, ts[:, None], -1)
        t["ol_vis"][at] = lvc
        last_order[wc, dc, b["c"][c]] = oc
        # stock: committed valid lines supplied in the home shard apply
        # now; the others go to the outbox
        m = lv & ok[:, None]
        cross = m & (b["supply_w"] // Wps != (w // Wps)[:, None])
        outbox.append((b["supply_w"][cross], b["i_id"][cross],
                       b["qty"][cross]))
        m &= ~cross
        sw, si, q = b["supply_w"][m], b["i_id"][m], b["qty"][m]
        remote = (b["supply_w"] != w[:, None])[m]
        np.add.at(t["s_quantity"], (sw, si), -q)
        np.add.at(t["s_ytd"], (sw, si), q.astype(f32))
        np.add.at(t["s_order_cnt"], (sw, si), 1)
        np.add.at(t["s_remote_cnt"], (sw, si), remote.astype(i32))
        if escrow:
            hm = hot[m]
            np.add.at(spent[0], pos[m][hm], q[hm])
        else:
            restock(sw, si)

    def restock(sw, si):
        """The spec's rule where a cell fell below 10: add 91 until it is
        at least 10."""
        sq = t["s_quantity"]
        low = sq[sw, si] < 10
        if low.any():
            cw, ci = sw[low], si[low]
            v = sq[cw, ci]
            v = np.where(v < 10, v + 91 * ((10 - v + 90) // 91), v)
            sq[cw, ci] = v

    def payment(b):
        w, d, c, amt = b["w"], b["d"], b["c"], b["amount"]
        if precision == "bfloat16":
            for x in range(len(w)):
                a = amt[x]
                t["w_ytd"][w[x]] = rnd(t["w_ytd"][w[x]] + a)
                t["d_ytd"][w[x], d[x]] = rnd(t["d_ytd"][w[x], d[x]] + a)
                t["h_amount_sum"][w[x], d[x]] = rnd(
                    t["h_amount_sum"][w[x], d[x]] + a)
                t["c_balance"][w[x], d[x], c[x]] = rnd(
                    t["c_balance"][w[x], d[x], c[x]] - a)
                t["c_ytd_payment"][w[x], d[x], c[x]] = rnd(
                    t["c_ytd_payment"][w[x], d[x], c[x]] + a)
        else:
            # np.add.at adds in index order, one add at a time, in float32
            np.add.at(t["w_ytd"], w, amt)
            np.add.at(t["d_ytd"], (w, d), amt)
            np.add.at(t["h_amount_sum"], (w, d), amt)
            np.add.at(t["c_balance"], (w, d, c), -amt)
            np.add.at(t["c_ytd_payment"], (w, d, c), amt)
        np.add.at(t["c_payment_cnt"], (w, d, c), 1)
        cnt["payments"] += len(w)

    def order_status(b):
        w, d, c = b["w"], b["d"], b["c"]
        oid = last_order[w, d, c]
        found = oid >= 0
        o = np.where(found, oid, 0)
        n = np.where(found, t["o_ol_cnt"][w, d, o], 0)
        need = line[None, :] < n[:, None]
        match = t["ol_ts"][w, d, o] == t["o_ts"][w, d, o][:, None]
        vis = t["ol_vis"][w, d, o]
        round1 = vis & match & need
        repaired = need & ~round1 & t["ol_valid"][w, d, o] & match
        lines_read = (round1 | repaired).sum(1)
        cnt["order_statuses"] += len(w)
        cnt["reads_found"] += int(found.sum())
        cnt["fractures_observed"] += int((found & (lines_read < n)).sum())
        cnt["lines_repaired"] += int(repaired.sum())
        read_lines.append((len(w), int(need.sum()), int((need & match).sum()),
                           int((need & match & ~vis).sum()),
                           int((round1 | repaired).sum())))

    def stock_level(b):
        w, d = b["w"], b["d"]
        K = min(STOCK_LEVEL_ORDERS, OC)
        nxt = t["d_next_o_id"][w, d].astype(np.int64)
        oid = nxt[:, None] - 1 - np.arange(K)[None, :]
        ring = (oid >= 0) & (oid >= nxt[:, None] - OC)
        o = np.where(ring, oid, 0)
        wk, dk = w[:, None], d[:, None]
        need = line[None, None, :] < t["o_ol_cnt"][wk, dk, o][..., None]
        match = t["ol_ts"][wk, dk, o] == t["o_ts"][wk, dk, o][..., None]
        round1 = t["ol_vis"][wk, dk, o] & match & need
        fractured = need & ~round1 & ring[..., None]
        repaired = fractured & t["ol_valid"][wk, dk, o] & match
        cnt["stock_levels"] += len(w)
        cnt["fractures_observed"] += int(fractured.sum() - repaired.sum())
        cnt["lines_repaired"] += int(repaired.sum())

    def delivery():
        key = np.where(t["no_valid"], t["o_entry_d"], np.iinfo(np.int32).max)
        slot = key.argmin(2)
        has = t["no_valid"].any(2)
        wI, dI = np.nonzero(has)
        o = slot[wI, dI]
        at = (wI, dI, o)
        ok = t["ol_valid"][at] & (t["ol_ts"][at] == t["o_ts"][at][:, None])
        vals = np.where(ok, t["ol_amount"][at], f32(0))
        amt = np.zeros(len(wI), f32)
        for l in range(L):                       # in line order, from 0
            amt = rnd(amt + vals[:, l])
        cust = t["o_c_id"][at]
        t["no_valid"][at] = False
        t["o_carrier"][at] = 1
        t["ol_delivered"][at] = t["ol_valid"][at]
        cat = (wI, dI, cust)
        t["c_balance"][cat] = rnd(t["c_balance"][cat] + amt)
        t["c_delivered_sum"][cat] = rnd(t["c_delivered_sum"][cat] + amt)
        t["c_delivery_cnt"][cat] += 1
        cnt["deliveries"] += len(wI)

    n = len(stream.neworder)
    for ci, lo in enumerate(range(0, n, merge_every)):
        for s in range(lo, min(lo + merge_every, n)):
            neworder(stream.neworder[s])
            if stream.payment is not None:
                payment(stream.payment[s])
            if stream.order_status is not None:
                order_status(stream.order_status[s])
            if stream.stock_level is not None:
                stock_level(stream.stock_level[s])
            if deliveries:
                delivery()
        # the drain: each owner adds the outbox's entries in its block,
        # each a remote line, then restocks; the escrow regime (one shard,
        # an empty outbox) then refreshes the shares from the stock
        sw, si, q = (np.concatenate(x) for x in zip(*outbox))
        outbox.clear()
        drained += len(sw)
        for r in range(R):
            own = sw // Wps == r
            ow, oi, oq = sw[own], si[own], q[own]
            np.add.at(t["s_quantity"], (ow, oi), -oq)
            np.add.at(t["s_ytd"], (ow, oi), oq.astype(f32))
            np.add.at(t["s_order_cnt"], (ow, oi), 1)
            np.add.at(t["s_remote_cnt"], (ow, oi), 1)
            if not escrow:
                restock(ow, oi)
        if escrow and (ci + 1) % refresh_every == 0:
            shares = t["s_quantity"].reshape(-1)[keys].astype(i32)[None, :]
            spent = np.zeros_like(shares)
    return PassResult(t, cnt, shares if escrow else None,
                      spent if escrow else None, read_lines, drained)
