"""The operations that cross shards, on one card.

The reference runs one program a device under ``shard_map`` and crosses
shards with ``all_gather``, ``psum`` and ``pmax``; its proof that a path
is coordination-free reads the compiled HLO for them
(``repro.utils.hlo.collective_stats``). The port holds R shards as
contiguous row blocks of the global tables on one card and runs each
shard's body on its own block (training's pods: a leaf's leading dim);
what crosses shards goes through the functions below, and nothing else
does. Each call adds to a count per kind, so a path's collectives are
counted as it runs:

* :func:`all_gather` — the shard-major concatenation of the per-shard
  tensors (an ``all-gather``);
* :func:`psum` — their sum, in shard order (an ``all-reduce``);
* :func:`pmax` — their elementwise max (an ``all-reduce`` too: the
  training merge's shared int8 scale).

:func:`counted` reads the counts of the calls made inside a ``with``
block as a :class:`CollectiveStats`, the analogue of the reference's
(``total_ops``, ``describe()``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Sequence

import torch

_COUNTS: Counter = Counter()
_BYTES: Counter = Counter()


@dataclasses.dataclass
class CollectiveStats:
    """Calls and bytes a kind (``all-gather``, ``all-reduce``): the bytes
    of an all-gather's output, of one operand of an all-reduce."""

    counts: Counter = dataclasses.field(default_factory=Counter)
    bytes: Counter = dataclasses.field(default_factory=Counter)

    @property
    def total_ops(self) -> int:
        return sum(self.counts.values())

    def describe(self) -> str:
        if not self.counts:
            return "collectives: NONE (coordination-free)"
        return "collectives: " + ", ".join(
            f"{op}×{n} ({self.bytes[op] / 1e6:.2f} MB)"
            for op, n in sorted(self.counts.items()))


def _count(kind: str, nbytes: int) -> None:
    _COUNTS[kind] += 1
    _BYTES[kind] += nbytes


@contextlib.contextmanager
def counted():
    """``with counted() as stats:`` — on exit ``stats`` holds the
    collectives called inside the block."""
    stats = CollectiveStats()
    counts, nbytes = Counter(_COUNTS), Counter(_BYTES)
    try:
        yield stats
    finally:
        stats.counts.update(_COUNTS - counts)
        stats.bytes.update(_BYTES - nbytes)


def _tiling(parts: Sequence[torch.Tensor]) -> torch.Tensor | None:
    """The one tensor the parts are, in order, when they are contiguous
    neighbouring blocks of one storage (the shard views of a global table);
    else None."""
    first = parts[0]
    ptr = first.untyped_storage().data_ptr()
    offset = first.storage_offset()
    for p in parts:
        if (not p.is_contiguous() or p.dim() == 0 or p.dtype != first.dtype
                or p.shape[1:] != first.shape[1:]
                or p.untyped_storage().data_ptr() != ptr
                or p.storage_offset() != offset):
            return None
        offset += p.numel()
    shape = (sum(p.shape[0] for p in parts),) + tuple(first.shape[1:])
    return first.as_strided(shape, torch.empty(shape, device="meta").stride(),
                            first.storage_offset())


def all_gather(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every shard's tensor, concatenated shard-major along dim 0. Where
    the parts are the shard views of one table, the table is that
    concatenation and is returned without a copy."""
    whole = _tiling(parts)
    if whole is None:
        whole = torch.cat(list(parts))
    _count("all-gather", whole.numel() * whole.element_size())
    return whole


def all_gather_tree(parts: Sequence):
    """:func:`all_gather` of each field of a tuple of tensors (a
    ``StockDelta``, a batch, a state): one all-gather a field."""
    return type(parts[0])(*(all_gather(xs) for xs in zip(*parts)))


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of every shard's tensor, added in shard order."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    _count("all-reduce", out.numel() * out.element_size())
    return out


def pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The elementwise max of every shard's tensor."""
    out = parts[0].clone()
    for p in parts[1:]:
        out = torch.maximum(out, p)
    _count("all-reduce", out.numel() * out.element_size())
    return out
