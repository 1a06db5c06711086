"""Join-semilattices (CRDTs), the paper's merge operator ``⊔``, in PyTorch.

The port of ``repro.core.lattice``. Database state is a bag of versioned
mutations with a commutative, associative, idempotent merge, realized as
fixed-shape tensors whose join is elementwise and whose bottom is an
identity:

    join(a, b) == join(b, a)                    (commutativity)
    join(a, join(b, c)) == join(join(a, b), c)  (associativity)
    join(a, a) == a                             (idempotence)
    join(a, bottom) == a                        (identity)

These are the requirements of Definition 3 (convergence). Every lattice
state is a NamedTuple of tensors, a group of the state trees that the
merge layer (``core/merge.py``) joins by lattice name.

Differences from the reference, all deliberate:

* dtypes are torch dtypes; the stamps the reference declares int64
  (``LWWRegister.ts``, ``VersionedSlots.version``) are int64 here whatever
  the setting (the reference narrows them to int32 with x64 off);
* ``make`` and the registry's bottoms take ``device`` (the CUDA card
  unless the caller asks for the CPU);
* ``VersionedSlots.join`` runs kernel B4 on the card
  (``kernels/lattice_merge.py``) and its plain version on the CPU;
* float sums over the replica axis (``value()``, ``remaining()``) add in
  replica order, as XLA does, so they equal the reference's bit for bit;
* the lease stamps stay host-side numpy int64, as in the reference;
* ``jitted_tree_join`` has no counterpart: torch runs eagerly.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import sum_lines

from . import tree

# ---------------------------------------------------------------------------
# Lattice registry: name -> (join, bottom), so the planner and the merge
# layer look joins up by state-spec metadata.
# ---------------------------------------------------------------------------

_JOINS: dict[str, Callable[[Any, Any], Any]] = {}
_BOTTOMS: dict[str, Callable[..., Any]] = {}


def register_lattice(name: str, join: Callable, bottom: Callable) -> None:
    if name in _JOINS:
        raise ValueError(f"lattice {name!r} already registered")
    _JOINS[name] = join
    _BOTTOMS[name] = bottom


def get_join(name: str) -> Callable:
    try:
        return _JOINS[name]
    except KeyError:
        raise KeyError(f"unknown lattice {name!r}; known: {sorted(_JOINS)}")


def get_bottom(name: str) -> Callable:
    return _BOTTOMS[name]


def _sum_replicas(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(axis=0)`` in replica order from 0, in ``x``'s dtype: the
    reference's sum, bit for bit for floats."""
    return sum_lines(x.movedim(0, -1))


def _scatter_add(x: torch.Tensor, index: tuple, amount) -> torch.Tensor:
    """The reference's ``x.at[index].add(amount)``: a copy of ``x`` with
    ``amount`` added at ``index``; duplicate indices accumulate."""
    idx = tuple(torch.as_tensor(i, device=x.device).long() for i in index)
    shape = torch.broadcast_shapes(*(i.shape for i in idx)) \
        + x.shape[len(idx):]
    vals = torch.as_tensor(amount, dtype=x.dtype, device=x.device)
    out = x.clone()
    out.index_put_(idx, vals.expand(shape), accumulate=True)
    return out


def _set_at(x: torch.Tensor, idx, value) -> torch.Tensor:
    """The reference's ``x.at[idx].set(value)``, as a copy."""
    out = x.clone()
    out[torch.as_tensor(idx, device=x.device).long()] = value
    return out


# ---------------------------------------------------------------------------
# Scalar/array lattices
# ---------------------------------------------------------------------------


def max_join(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """MaxReg: monotone registers (step counters, high-water marks)."""
    return torch.maximum(a, b)


def min_join(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.minimum(a, b)


def or_join(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GSet over a fixed universe, encoded as a boolean membership mask."""
    return torch.logical_or(a, b)


def and_join(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.logical_and(a, b)


def sum_join(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NOT a lattice join (not idempotent): for *delta* merges of disjoint
    contributions, each consumed once per merge epoch."""
    return a + b


def _max_bottom(shape=(), dtype=torch.int32, device=None) -> torch.Tensor:
    fill = -float("inf") if dtype.is_floating_point \
        else torch.iinfo(dtype).min
    return torch.full(shape, fill, dtype=dtype,
                      device=resolve_device(device))


def _min_bottom(shape=(), dtype=torch.int32, device=None) -> torch.Tensor:
    fill = float("inf") if dtype.is_floating_point \
        else torch.iinfo(dtype).max
    return torch.full(shape, fill, dtype=dtype,
                      device=resolve_device(device))


register_lattice("max", max_join, _max_bottom)
register_lattice("min", min_join, _min_bottom)
register_lattice("or", or_join, lambda shape=(), dtype=torch.bool,
                 device=None: torch.zeros(shape, dtype=dtype,
                                          device=resolve_device(device)))
register_lattice("and", and_join, lambda shape=(), dtype=torch.bool,
                 device=None: torch.ones(shape, dtype=dtype,
                                         device=resolve_device(device)))
register_lattice("sum", sum_join, lambda shape=(), dtype=torch.float32,
                 device=None: torch.zeros(shape, dtype=dtype,
                                          device=resolve_device(device)))


# ---------------------------------------------------------------------------
# GCounter / PNCounter — per-replica slot counters (paper §5.2 ADTs)
# ---------------------------------------------------------------------------


class GCounter(NamedTuple):
    """Grow-only counter: ``slots[r]`` is replica *r*'s local contribution.
    value() = sum of slots; join = slotwise max."""

    slots: torch.Tensor  # [num_replicas, *value_shape]

    @staticmethod
    def make(num_replicas: int, value_shape: tuple = (),
             dtype=torch.float32, device=None) -> "GCounter":
        return GCounter(torch.zeros((num_replicas, *value_shape),
                                    dtype=dtype,
                                    device=resolve_device(device)))

    def increment(self, replica, amount=1) -> "GCounter":
        return GCounter(_scatter_add(self.slots, (replica,), amount))

    def value(self) -> torch.Tensor:
        return _sum_replicas(self.slots)

    @staticmethod
    def join(a: "GCounter", b: "GCounter") -> "GCounter":
        return GCounter(torch.maximum(a.slots, b.slots))


class PNCounter(NamedTuple):
    """Increment/decrement counter = pair of GCounters (paper §5.2).
    Convergent, but does NOT by itself preserve threshold invariants."""

    pos: GCounter
    neg: GCounter

    @staticmethod
    def make(num_replicas: int, value_shape: tuple = (),
             dtype=torch.float32, device=None) -> "PNCounter":
        return PNCounter(GCounter.make(num_replicas, value_shape, dtype,
                                       device),
                         GCounter.make(num_replicas, value_shape, dtype,
                                       device))

    def increment(self, replica, amount=1) -> "PNCounter":
        return self._replace(pos=self.pos.increment(replica, amount))

    def decrement(self, replica, amount=1) -> "PNCounter":
        return self._replace(neg=self.neg.increment(replica, amount))

    def value(self) -> torch.Tensor:
        return self.pos.value() - self.neg.value()

    @staticmethod
    def join(a: "PNCounter", b: "PNCounter") -> "PNCounter":
        return PNCounter(GCounter.join(a.pos, b.pos),
                         GCounter.join(a.neg, b.neg))


register_lattice("gcounter", GCounter.join, GCounter.make)
register_lattice("pncounter", PNCounter.join, PNCounter.make)


# ---------------------------------------------------------------------------
# Observability lattices: monotone counters and merge-able histograms
# ---------------------------------------------------------------------------


class CounterLattice(NamedTuple):
    """The metrics-plane G-counter: integer per-replica slots ``[R, *shape]``,
    with a vectorized :meth:`bump`; join = slotwise max."""

    slots: torch.Tensor  # [num_replicas, *value_shape] int

    @staticmethod
    def make(num_replicas: int, value_shape: tuple = (),
             dtype=torch.int32, device=None) -> "CounterLattice":
        return CounterLattice(torch.zeros((num_replicas, *value_shape),
                                          dtype=dtype,
                                          device=resolve_device(device)))

    def bump(self, replica, idx=None, amount=1) -> "CounterLattice":
        """Add ``amount`` to this replica's slot, at ``idx`` (any integer
        index array; duplicate indices accumulate) or to the whole slot."""
        index = (replica,) if idx is None else (replica, idx)
        return CounterLattice(_scatter_add(self.slots, index, amount))

    def value(self) -> torch.Tensor:
        return _sum_replicas(self.slots)

    @staticmethod
    def join(a: "CounterLattice", b: "CounterLattice") -> "CounterLattice":
        return CounterLattice(torch.maximum(a.slots, b.slots))


def log_bin_edges(n_bins: int, lo: float = 1.0, base: float = 2.0,
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """The ``n_bins - 1`` interior edges of a fixed log-spaced binning: bin 0
    is ``[0, lo*base)``, bin k ``[lo*base**k, lo*base**(k+1))``, the last
    bin open above."""
    k = torch.arange(1, n_bins, dtype=torch.float32,
                     device=resolve_device(device))
    return (lo * base ** k).to(dtype)


class HistogramLattice(NamedTuple):
    """Merge-able histogram: per-replica monotone bin counts over FIXED
    log-spaced edges. Join = slotwise max (keeps the left operand's
    edges)."""

    edges: torch.Tensor   # [n_bins - 1] interior edges, ascending
    counts: torch.Tensor  # [num_replicas, *extra, n_bins] int

    @staticmethod
    def make(num_replicas: int, n_bins: int = 16, lo: float = 1.0,
             base: float = 2.0, extra_shape: tuple = (),
             dtype=torch.int32, device=None) -> "HistogramLattice":
        dev = resolve_device(device)
        return HistogramLattice(
            log_bin_edges(n_bins, lo, base, device=dev),
            torch.zeros((num_replicas, *extra_shape, n_bins), dtype=dtype,
                        device=dev))

    @property
    def n_bins(self) -> int:
        return self.counts.shape[-1]

    def bin_of(self, values) -> torch.Tensor:
        """Bin index of each value (``searchsorted``, side right)."""
        v = torch.as_tensor(values, device=self.edges.device).to(
            self.edges.dtype)
        return torch.searchsorted(self.edges, v.contiguous(),
                                  right=True).to(torch.int32)

    def observe(self, replica, values, weights=None) -> "HistogramLattice":
        """Record a batch of values into this replica's lane. ``weights``
        (int, e.g. a validity mask) defaults to 1 per value."""
        bins = self.bin_of(values)
        w = 1 if weights is None else torch.as_tensor(
            weights, device=self.counts.device).to(self.counts.dtype)
        return self._replace(counts=_scatter_add(self.counts,
                                                 (replica, bins), w))

    def value(self) -> torch.Tensor:
        """Merged bin counts across replicas ([*extra, n_bins])."""
        return _sum_replicas(self.counts)

    @staticmethod
    def join(a: "HistogramLattice", b: "HistogramLattice"
             ) -> "HistogramLattice":
        return HistogramLattice(a.edges, torch.maximum(a.counts, b.counts))


register_lattice("counter", CounterLattice.join, CounterLattice.make)
register_lattice("histogram", HistogramLattice.join, HistogramLattice.make)


# ---------------------------------------------------------------------------
# LWW register — the destructive merge the paper cautions about (§5.2)
# ---------------------------------------------------------------------------


class LWWRegister(NamedTuple):
    """Last-writer-wins register: join keeps the higher (ts, replica)
    stamp. Provided to illustrate Lost Update; never recommended for
    counter-like state."""

    value: torch.Tensor
    ts: torch.Tensor       # int64 logical timestamp
    replica: torch.Tensor  # int32 tie-break

    @staticmethod
    def make(value, ts=0, replica=0, device=None) -> "LWWRegister":
        dev = resolve_device(device)
        return LWWRegister(torch.as_tensor(value, device=dev),
                           torch.as_tensor(ts, dtype=torch.int64, device=dev),
                           torch.as_tensor(replica, dtype=torch.int32,
                                           device=dev))

    def write(self, value, ts, replica) -> "LWWRegister":
        dev = self.value.device
        value = torch.as_tensor(value, dtype=self.value.dtype, device=dev)
        ts = torch.as_tensor(ts, dtype=self.ts.dtype, device=dev)
        replica = torch.as_tensor(replica, dtype=self.replica.dtype,
                                  device=dev)
        newer = (ts > self.ts) | ((ts == self.ts) & (replica > self.replica))
        return LWWRegister(torch.where(newer, value, self.value),
                           torch.maximum(self.ts, ts),
                           torch.where(newer, replica, self.replica))

    @staticmethod
    def join(a: "LWWRegister", b: "LWWRegister") -> "LWWRegister":
        b_newer = (b.ts > a.ts) | ((b.ts == a.ts) & (b.replica > a.replica))
        return LWWRegister(torch.where(b_newer, b.value, a.value),
                           torch.maximum(a.ts, b.ts),
                           torch.where(b_newer, b.replica, a.replica))


register_lattice("lww", LWWRegister.join, LWWRegister.make)


# ---------------------------------------------------------------------------
# Two-phase set (add + tombstone) — cascading-delete support (§5.1 FKs)
# ---------------------------------------------------------------------------


class TwoPhaseSet(NamedTuple):
    """Fixed-universe 2P-set: once removed, an element never reappears.
    ``added`` and ``removed`` are grow-only masks; membership is
    ``added & ~removed``."""

    added: torch.Tensor    # bool mask over universe
    removed: torch.Tensor  # bool mask over universe

    @staticmethod
    def make(universe: int, device=None) -> "TwoPhaseSet":
        dev = resolve_device(device)
        return TwoPhaseSet(torch.zeros(universe, dtype=torch.bool, device=dev),
                           torch.zeros(universe, dtype=torch.bool, device=dev))

    def add(self, idx) -> "TwoPhaseSet":
        return self._replace(added=_set_at(self.added, idx, True))

    def remove(self, idx) -> "TwoPhaseSet":
        return self._replace(removed=_set_at(self.removed, idx, True))

    def members(self) -> torch.Tensor:
        return self.added & ~self.removed

    @staticmethod
    def join(a: "TwoPhaseSet", b: "TwoPhaseSet") -> "TwoPhaseSet":
        return TwoPhaseSet(a.added | b.added, a.removed | b.removed)


register_lattice("2pset", TwoPhaseSet.join, TwoPhaseSet.make)


# ---------------------------------------------------------------------------
# Escrow counter — paper §8 "Amortizing coordination" (O'Neil's escrow)
# ---------------------------------------------------------------------------


class EscrowCounter(NamedTuple):
    """A global budget pre-partitioned into per-replica shares: spending is
    local, the ``value >= floor`` invariant holds globally by construction,
    and replicas coordinate only to refresh shares. join = slotwise max of
    spent, min of shares (conservative across refresh epochs)."""

    shares: torch.Tensor  # [R] allocated share per replica
    spent: torch.Tensor   # [R] monotone local spend

    @staticmethod
    def make(num_replicas: int, budget: float, floor: float = 0.0,
             dtype=torch.float32, device=None) -> "EscrowCounter":
        dev = resolve_device(device)
        headroom = torch.tensor(budget - floor, dtype=dtype, device=dev)
        return EscrowCounter(
            (headroom / num_replicas).repeat(num_replicas).to(dtype),
            torch.zeros((num_replicas,), dtype=dtype, device=dev))

    def try_spend(self, replica, amount) -> tuple["EscrowCounter",
                                                  torch.Tensor]:
        """Local, coordination-free spend. Returns (state, ok)."""
        amount = torch.as_tensor(amount, dtype=self.spent.dtype,
                                 device=self.spent.device)
        cur = self.spent[replica]
        ok = cur + amount <= self.shares[replica]
        spent = self.spent.clone()
        spent[replica] = torch.where(ok, cur + amount, cur)
        return self._replace(spent=spent), ok

    def remaining(self) -> torch.Tensor:
        return sum_lines(self.shares - self.spent)

    def refresh(self, alive=None) -> "EscrowCounter":
        """The amortized coordination point: rebalance unspent headroom.
        ``alive`` ([R] mask) folds dead replicas' headroom into the
        survivors' fresh shares and zeroes their own."""
        headroom = self.remaining()
        n = self.shares.shape[0]
        if alive is None:
            return EscrowCounter((headroom / n).repeat(n).to(
                self.shares.dtype), torch.zeros_like(self.spent))
        alive_f = torch.as_tensor(alive, device=self.shares.device).to(
            self.shares.dtype)
        n_live = torch.clamp_min(sum_lines(alive_f), 1)
        return EscrowCounter((alive_f * headroom / n_live).to(
            self.shares.dtype), torch.zeros_like(self.spent))

    @staticmethod
    def join(a: "EscrowCounter", b: "EscrowCounter") -> "EscrowCounter":
        """Slotwise merge, INTENTIONALLY CONSERVATIVE on shares: ``min``
        never manufactures admission capacity across refresh epochs."""
        return EscrowCounter(torch.minimum(a.shares, b.shares),
                             torch.maximum(a.spent, b.spent))


register_lattice("escrow", EscrowCounter.join, EscrowCounter.make)


# ---------------------------------------------------------------------------
# Hot-set escrow — the sparse two-tier variant (paper §8): shares only for
# the top-K contended cells; the cold tail is owner-routed.
# ---------------------------------------------------------------------------


def hot_position(hot_keys: torch.Tensor,
                 key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(position, is_hot)`` of cell ``key`` in the sorted ``hot_keys``
    table (O(log K) per query, ``searchsorted`` with side left).

    The clip-then-compare idiom is the reference's: the position is clipped
    into ``[0, K)`` and membership is the equality at that position.
    ``K == 0`` (an empty hot set: every cell cold) returns ``is_hot == False``
    everywhere instead of indexing out of range.
    """
    K = hot_keys.shape[0]
    if K == 0:
        return (torch.zeros(key.shape, dtype=torch.int32, device=key.device),
                torch.zeros(key.shape, dtype=torch.bool, device=key.device))
    pos = torch.searchsorted(hot_keys, key.to(hot_keys.dtype).contiguous(),
                             out_int32=True).clamp_(0, K - 1)
    return pos, hot_keys[pos.long()] == key


class HotSetEscrow(NamedTuple):
    """Per-replica escrow shares over a sparse hot set of K contended cells.

    ``keys`` — ``[K]`` int32 sorted unique cell ids; ``shares`` / ``spent``
    — ``[R, K]`` int32 per-replica slots. Cold cells carry no escrow state:
    their decrements are serialized at the owning shard.
    """

    keys: torch.Tensor    # [K] int32 sorted unique cell keys
    shares: torch.Tensor  # [R, K] int32
    spent: torch.Tensor   # [R, K] int32

    @staticmethod
    def make(num_replicas: int, keys, budgets, alive=None,
             device=None) -> "HotSetEscrow":
        """Partition ``budgets`` ([K], the current stock of each hot cell)
        into per-replica shares with ``shares.sum(0) == budgets`` exactly:
        ``q // R`` each, the remainder to the lowest (live) ranks. ``alive``
        ([R] mask) gives dead replicas ZERO shares. The table lives on
        ``keys``' device when it is a tensor, else on ``device`` (the card
        unless the caller asks for the CPU)."""
        if not torch.is_tensor(keys):
            keys = torch.as_tensor(keys, device=resolve_device(device))
        keys = keys.to(torch.int32)
        q = torch.as_tensor(budgets, dtype=torch.int32, device=keys.device)
        if alive is None:
            r = torch.arange(num_replicas, dtype=torch.int32,
                             device=keys.device)[:, None]
            shares = q[None, :] // num_replicas + (
                r < q[None, :] % num_replicas).to(torch.int32)
        else:
            alive_i = torch.as_tensor(alive, dtype=torch.int32,
                                      device=keys.device)
            n_live = alive_i.sum().clamp_min(1).to(torch.int32)
            rank = (torch.cumsum(alive_i, 0).to(torch.int32) - 1)[:, None]
            shares = (q[None, :] // n_live + (
                rank < q[None, :] % n_live).to(torch.int32)) \
                * alive_i[:, None]
        return HotSetEscrow(keys, shares, torch.zeros_like(shares))

    @property
    def n_hot(self) -> int:
        return self.keys.shape[0]

    def lookup(self, key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(position, is_hot) for cell ``key`` through :func:`hot_position`."""
        return hot_position(self.keys, key)

    def try_spend(self, replica: int, key: torch.Tensor,
                  amount) -> tuple["HotSetEscrow", torch.Tensor]:
        """Local spend against this replica's share of a HOT cell. Returns
        (state, ok); a cold key is rejected with the state unchanged."""
        pos, hot = self.lookup(key)
        p = pos.long()
        amount = torch.as_tensor(amount, dtype=torch.int32,
                                 device=self.spent.device)
        cur = self.spent[replica, p]
        ok = hot & (cur + amount <= self.shares[replica, p])
        spent = self.spent.clone()
        spent[replica, p] = torch.where(ok, cur + amount, cur)
        return self._replace(spent=spent), ok

    def remaining(self) -> torch.Tensor:
        """Per-cell unspent headroom across replicas ([K] int32)."""
        return (self.shares - self.spent).sum(0).to(torch.int32)

    def refresh(self, budgets, alive=None) -> "HotSetEscrow":
        """Re-partition the hot cells' post-drain stock into fresh shares;
        spent resets."""
        return HotSetEscrow.make(self.shares.shape[0], self.keys, budgets,
                                 alive=alive)

    @staticmethod
    def join(a: "HotSetEscrow", b: "HotSetEscrow") -> "HotSetEscrow":
        """Same-epoch merge (equal keys): min shares / max spent."""
        return HotSetEscrow(a.keys, torch.minimum(a.shares, b.shares),
                            torch.maximum(a.spent, b.spent))


register_lattice("escrow_hot", HotSetEscrow.join, HotSetEscrow.make)


# ---------------------------------------------------------------------------
# Versioned slots — the dense stand-in for the paper's bag of versions
# ---------------------------------------------------------------------------


class VersionedSlots(NamedTuple):
    """A table of fixed capacity whose rows carry (valid, version, payload).

    * insert-only tables: valid is a grow-only mask (or-join);
    * updatable tables: join keeps the payload of the strictly higher
      version, ``a``'s on a tie (replica-namespaced versions keep them
      unique, §5.1 "choose some value").

    The store primitive of ``txn/store.py``. Its join is kernel B4
    (``kernels/lattice_merge.py``) on the card and the kernel's plain
    version on the CPU, with the audit mask dropped.
    """

    valid: torch.Tensor    # [cap] bool
    version: torch.Tensor  # [cap] int64 (replica-namespaced: ts * R + replica)
    payload: torch.Tensor  # [cap, width] payload columns

    @staticmethod
    def make(capacity: int, width: int, dtype=torch.float32,
             device=None) -> "VersionedSlots":
        dev = resolve_device(device)
        return VersionedSlots(
            torch.zeros((capacity,), dtype=torch.bool, device=dev),
            torch.full((capacity,), -1, dtype=torch.int64, device=dev),
            torch.zeros((capacity, width), dtype=dtype, device=dev))

    def upsert(self, idx, version, row) -> "VersionedSlots":
        """Write one row (``idx`` a scalar, as in the reference) if
        ``version`` is newer; the row becomes valid either way."""
        idx = int(idx)
        dev = self.payload.device
        version = torch.as_tensor(version, dtype=torch.int64, device=dev)
        row = torch.as_tensor(row, dtype=self.payload.dtype, device=dev)
        newer = version > self.version[idx]
        valid, ver, pay = (x.clone() for x in self)
        valid[idx] = True
        ver[idx] = torch.maximum(ver[idx], version)
        pay[idx] = torch.where(newer, row, pay[idx])
        return VersionedSlots(valid, ver, pay)

    @staticmethod
    def join(a: "VersionedSlots", b: "VersionedSlots") -> "VersionedSlots":
        valid, version, payload, _ = ops.lattice_merge(
            a.valid, a.version, a.payload, b.valid, b.version, b.payload)
        return VersionedSlots(valid, version, payload)


register_lattice("versioned", VersionedSlots.join, VersionedSlots.make)


# ---------------------------------------------------------------------------
# Lease lattice — liveness as a CALM computation (heartbeat high-water
# marks). Host-side numpy int64, as in the reference: the stamps ride the
# drain exchange as metadata, not as device tensors.
# ---------------------------------------------------------------------------


_LEASE_EPOCH_SHIFT = 32


def pack_lease_stamp(epoch, seq):
    """Pack an (epoch, seq) heartbeat into one monotone int64 stamp."""
    return (np.asarray(epoch, np.int64) << _LEASE_EPOCH_SHIFT) | (
        np.asarray(seq, np.int64) & ((1 << _LEASE_EPOCH_SHIFT) - 1))


def unpack_lease_stamp(stamp):
    stamp = np.asarray(stamp, np.int64)
    return (stamp >> _LEASE_EPOCH_SHIFT,
            stamp & ((1 << _LEASE_EPOCH_SHIFT) - 1))


class LeaseLattice(NamedTuple):
    """Per-replica heartbeat high-water marks; join = elementwise MaxReg.
    Declaring a replica dead is a local threshold over this lattice, never
    a negotiated decision."""

    stamps: np.ndarray  # [R] int64 packed (epoch, seq) high-water marks

    @staticmethod
    def make(n_replicas: int) -> "LeaseLattice":
        return LeaseLattice(np.zeros((n_replicas,), np.int64))

    def beat(self, replica, epoch, seq) -> "LeaseLattice":
        """Record replica's own heartbeat (a monotone local write)."""
        stamps = np.asarray(self.stamps, np.int64).copy()
        stamps[replica] = max(int(stamps[replica]),
                              int(pack_lease_stamp(epoch, seq)))
        return LeaseLattice(stamps)

    @staticmethod
    def join(a: "LeaseLattice", b: "LeaseLattice") -> "LeaseLattice":
        return LeaseLattice(np.maximum(np.asarray(a.stamps, np.int64),
                                       np.asarray(b.stamps, np.int64)))


register_lattice("lease", LeaseLattice.join, LeaseLattice.make)

# the lattice types: each is one logical group of a state tree
LATTICE_TYPES = (GCounter, PNCounter, LWWRegister, TwoPhaseSet, EscrowCounter,
                 HotSetEscrow, VersionedSlots, CounterLattice,
                 HistogramLattice, LeaseLattice)


# ---------------------------------------------------------------------------
# Tree-level merge: a named join per logical group of matching state trees
# ---------------------------------------------------------------------------


def tree_join(join_names: Any, a: Any, b: Any) -> Any:
    """Join two state trees group by group. ``join_names`` mirrors the
    top-level structure of the state tree with a lattice name at each
    logical group (a whole GCounter counts as one)."""
    names, treedef = tree.flatten(join_names,
                                  is_leaf=lambda x: isinstance(x, str))
    a_groups = tree.flatten_up_to(treedef, a)
    b_groups = tree.flatten_up_to(treedef, b)
    out = [get_join(n)(x, y) for n, x, y in zip(names, a_groups, b_groups)]
    return tree.unflatten(treedef, out)


def tree_join_flat(names: tuple, a: Any, b: Any) -> Any:
    """Join where ``names`` aligns with the logical groups of ``a``: the
    lattice NamedTuples, and every other leaf of the tree."""
    a_groups, treedef = tree.flatten(
        a, is_leaf=lambda x: isinstance(x, LATTICE_TYPES))
    b_groups = tree.flatten_up_to(treedef, b)
    if len(names) != len(a_groups):
        raise ValueError(f"{len(names)} names for {len(a_groups)} state "
                         f"groups")
    out = [get_join(n)(x, y) for n, x, y in zip(names, a_groups, b_groups)]
    return tree.unflatten(treedef, out)


# ---------------------------------------------------------------------------
# Property helpers used by the hypothesis suite
# ---------------------------------------------------------------------------


def leaves_equal(x: Any, y: Any) -> bool:
    """Two trees with equal leaves, value for value (tensors or numpy)."""
    lx, ly = tree.leaves(x), tree.leaves(y)
    return len(lx) == len(ly) and all(
        torch.equal(torch.as_tensor(u), torch.as_tensor(v))
        for u, v in zip(lx, ly))


def check_lattice_laws(join: Callable, samples: list,
                       eq: Callable | None = None) -> None:
    """Assert commutativity/associativity/idempotence over concrete
    samples."""
    eq = eq or leaves_equal
    for a in samples:
        assert eq(join(a, a), a), "idempotence violated"
        for b in samples:
            assert eq(join(a, b), join(b, a)), "commutativity violated"
            for c in samples:
                assert eq(join(a, join(b, c)), join(join(a, b), c)), \
                    "associativity violated"
