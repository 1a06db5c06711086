"""The lattice subset the TPC-C escrow path uses, in PyTorch.

The reference (``repro.core.lattice``) realizes the paper's merge operator
over fixed-shape arrays. The New-Order slice needs only two pieces of it:

* :func:`hot_position` — THE hot-table probe shared by sparse escrow
  admission and the owner-side strict drain, so a cell can never be hot on
  one side and cold on the other;
* :class:`HotSetEscrow` — per-replica escrow shares over the sparse hot set
  of contended cells (paper §8), with the reference's field layout.

Stored tensors are int32; int64 appears only where torch indexes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device


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
