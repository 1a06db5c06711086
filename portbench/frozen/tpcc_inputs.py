"""Frozen copies of the TPC-C input draws: the initial tables' random
columns and the transaction streams, draw for draw as the port's
``repro_torch.txn.tpcc.init_state`` and ``generate_*`` /
``neworder_batch`` / ``home_partitioned`` /
``txn.drivers.generate_mix_batches`` make them, as plain NumPy.

A deployment of R warehouse shards keeps shard r's warehouses in the
block ``[r * W / R, (r + 1) * W / R)``, and every batch of ``batch``
transactions is R home-partitioned parts of ``batch / R`` rows,
shard-major, each part's home warehouses drawn in its shard's block (the
port's layout, ``tpcc.neworder_batch``). At R = 1 the one part is the
whole batch over every warehouse.

The benchmark makes every input here, from ``--seed``, and hands the same
arrays to the program and to the reference. A test
(``portbench/tests/test_portbench_frozen.py``) holds them equal to the
port's functions; a change to the port's generators leaves these as they
are, so the inputs a cell measures never move with the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Scale:
    """TPC-C cardinalities (the port's ``TPCCScale`` fields)."""

    n_warehouses: int
    districts: int
    customers: int
    n_items: int
    order_capacity: int
    max_lines: int


def rng_for(seed: int, purpose: int) -> np.random.Generator:
    """The generator of one purpose of a run (0 the initial tables, 1 the
    instance's stream, 2 its new names, 3 the judged pass's stream), from the seed's magnitude, its sign and the purpose: any
    whole number is a seed."""
    return np.random.default_rng([abs(seed), int(seed < 0), purpose])


@dataclasses.dataclass
class InitialDraws:
    """The random columns of the initial tables (every other column starts
    at a constant: zeros, -1 for stamps and carriers, False for flags)."""

    price: np.ndarray       # [I] f32 (replicated per warehouse as i_price)
    w_tax: np.ndarray       # [W] f32
    d_tax: np.ndarray       # [W, D] f32
    c_discount: np.ndarray  # [W, D, C] f32
    s_quantity: np.ndarray  # [W, I] int32


def initial_draws(scale: Scale, rng: np.random.Generator,
                  stock_multiplier: int = 1) -> InitialDraws:
    """``init_state``'s draws, in its order; ``stock_multiplier`` scales the
    stock afterwards (the escrow deployments' setting)."""
    W, D, C, I = (scale.n_warehouses, scale.districts, scale.customers,
                  scale.n_items)
    price = rng.uniform(1.0, 100.0, size=(I,)).astype(np.float32)
    w_tax = rng.uniform(0.0, 0.2, (W,)).astype(np.float32)
    d_tax = rng.uniform(0.0, 0.2, (W, D)).astype(np.float32)
    c_discount = rng.uniform(0.0, 0.5, (W, D, C)).astype(np.float32)
    s_quantity = rng.integers(10, 101, (W, I)).astype(np.int32)
    if stock_multiplier != 1:
        s_quantity *= np.int32(stock_multiplier)
    return InitialDraws(price, w_tax, d_tax, c_discount, s_quantity)


def check_shards(scale: Scale, batch: int, n_shards: int, name: str
                 ) -> None:
    """``SystemExit`` naming the configuration ``name`` unless
    ``n_shards`` divides both W and ``batch``."""
    W = scale.n_warehouses
    if n_shards < 1 or W % n_shards or batch % n_shards:
        raise SystemExit(f"portbench: configuration {name!r}: {n_shards} "
                         f"shards must divide its {W} warehouses and the "
                         f"batch of {batch}")


def item_popularity(n_items: int, theta: float) -> np.ndarray:
    """Zipfian profile by id: p(i) proportional to 1 / (i + 1)**theta."""
    p = 1.0 / np.power(np.arange(1, n_items + 1, dtype=np.float64), theta)
    return p / p.sum()


def neworder(rng, scale: Scale, batch: int, remote_frac: float, w_lo: int,
             w_hi: int, ts0: int, item_skew: float, cdf=None) -> dict:
    """One shard's New-Order inputs (``generate_neworder``)."""
    L = scale.max_lines
    w = rng.integers(w_lo, w_hi, batch).astype(np.int32)
    n_lines = rng.integers(5, L + 1, batch).astype(np.int32)
    if item_skew > 0:
        if cdf is None:
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
    return dict(w=w, d=d, c=c, n_lines=n_lines, i_id=i_id, supply_w=supply,
                qty=qty, ts=ts)


def payment(rng, scale: Scale, batch: int, w_lo: int, w_hi: int) -> dict:
    """One shard's Payment inputs (``generate_payment``)."""
    w = rng.integers(w_lo, w_hi, batch).astype(np.int32)
    d = rng.integers(0, scale.districts, batch).astype(np.int32)
    c = rng.integers(0, scale.customers, batch).astype(np.int32)
    amount = rng.uniform(1.0, 5000.0, batch).astype(np.float32)
    return dict(w=w, d=d, c=c, amount=amount)


def order_status(rng, scale: Scale, batch: int, w_lo: int, w_hi: int
                 ) -> dict:
    """One shard's Order-Status inputs (``generate_order_status``)."""
    w = rng.integers(w_lo, w_hi, batch).astype(np.int32)
    d = rng.integers(0, scale.districts, batch).astype(np.int32)
    c = rng.integers(0, scale.customers, batch).astype(np.int32)
    return dict(w=w, d=d, c=c)


def stock_level(rng, scale: Scale, batch: int, w_lo: int, w_hi: int
                ) -> dict:
    """One shard's Stock-Level inputs (``generate_stock_level``)."""
    w = rng.integers(w_lo, w_hi, batch).astype(np.int32)
    d = rng.integers(0, scale.districts, batch).astype(np.int32)
    threshold = rng.integers(10, 21, batch).astype(np.int32)
    return dict(w=w, d=d, threshold=threshold)


@dataclasses.dataclass
class PassStream:
    """One pass's batches, each a dict of arrays; the lists the mix does
    not draw are None."""

    neworder: list[dict]
    payment: list[dict] | None
    order_status: list[dict] | None
    stock_level: list[dict] | None


def pass_stream(rng, scale: Scale, *, batch: int, n_batches: int,
                remote_frac: float, item_skew: float, payments: bool,
                reads: bool, read_frac: float, ts0: int = 0,
                n_shards: int = 1) -> PassStream:
    """A pass's stream over ``n_shards`` shards, its New-Order stamps from
    ``ts0`` on, each shard's part stamped after the previous part's
    (``tpcc.neworder_batch``). A batch is ``n_shards`` parts of ``batch /
    n_shards`` rows, part r homed in shard r's block; supply warehouses
    stay drawn over all W. With ``reads`` the draws are
    ``generate_mix_batches``' (a New-Order, a Payment, an Order-Status and
    a Stock-Level batch a step, one generator, each batch part by part);
    without, ``run_loop``'s (the New-Order batches, then with
    ``payments`` the Payment batches). ``batch`` must divide by
    ``n_shards`` (``check_shards``)."""
    Wps, per = scale.n_warehouses // n_shards, batch // n_shards
    cdf = (np.cumsum(item_popularity(scale.n_items, item_skew))
           if item_skew > 0 else None)

    def parts(gen, rows, **kw):
        bs = [gen(rng, scale, rows, r * Wps, (r + 1) * Wps, **kw)
              for r in range(n_shards)]
        return {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}

    def no_batch():
        nonlocal ts0
        bs = []
        for r in range(n_shards):
            bs.append(neworder(rng, scale, per, remote_frac, r * Wps,
                               (r + 1) * Wps, ts0, item_skew, cdf))
            ts0 += per
        return {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}

    if reads:
        per_reads = max(1, int(per * read_frac))
        no, pay, os_, sl = [], [], [], []
        for _ in range(n_batches):
            no.append(no_batch())
            pay.append(parts(payment, per))
            os_.append(parts(order_status, per_reads))
            sl.append(parts(stock_level, per_reads))
        return PassStream(no, pay if payments else None, os_, sl)
    no = [no_batch() for _ in range(n_batches)]
    pay = ([parts(payment, per) for _ in range(n_batches)]
           if payments else None)
    return PassStream(no, pay, None, None)


def relabel(scale: Scale, draws: InitialDraws, stream: PassStream,
            rng: np.random.Generator, n_shards: int = 1
            ) -> tuple[InitialDraws, PassStream]:
    """The same instance under new names: warehouses permuted within each
    of the ``n_shards`` shards' blocks, districts and customers permuted,
    in the tables and in every batch alike. Items keep their ids
    (popularity is by id). Every row keeps its home shard and every line
    its local or cross-shard supply, and every transaction meets the same
    stock and makes the same choices, so the work, the aborts and the
    floats are the instance's, in another layout."""
    W, D, C = scale.n_warehouses, scale.districts, scale.customers
    Wps = W // n_shards
    pw = np.concatenate([r * Wps + rng.permutation(Wps)
                         for r in range(n_shards)]).astype(np.int32)
    pd = rng.permutation(D).astype(np.int32)
    pc = rng.permutation(C).astype(np.int32)

    def moved(a, *perms):
        out = np.empty_like(a)
        out[np.ix_(*perms)] = a
        return out

    draws = InitialDraws(draws.price, moved(draws.w_tax, pw),
                         moved(draws.d_tax, pw, pd),
                         moved(draws.c_discount, pw, pd, pc),
                         moved(draws.s_quantity, pw,
                               np.arange(scale.n_items)))
    names = {"w": pw, "supply_w": pw, "d": pd, "c": pc}

    def batch(b):
        return {k: names[k][v] if k in names else v for k, v in b.items()}

    return draws, PassStream(*(None if bs is None else [batch(b) for b in bs]
                               for bs in (stream.neworder, stream.payment,
                                          stream.order_status,
                                          stream.stock_level)))
