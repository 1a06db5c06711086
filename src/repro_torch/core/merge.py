"""State-tree merge (the ⊔ operator at runtime) and anti-entropy.

The port of ``repro.core.merge``'s out-of-program merges: host-held state
trees (divergent replica snapshots after a failure, TPC-C replica states)
joined group by group through the lattice registry. Torch runs eagerly,
so :func:`merge_trees` is a plain function where the reference jits one
per tree structure.

A ``"versioned"`` group joins through ``VersionedSlots.join``, which is
kernel B4 (``kernels/lattice_merge.py``) on the card, so every merge of a
tree with versioned groups launches it there. :func:`merge_versioned_fused`
adds the kernel's threshold audit to the join.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.kernels import ops as kops

from . import lattice, tree
from .lattice import VersionedSlots
from .planner import CoordinationPlan


def plan_lattice_names(plan: CoordinationPlan) -> tuple[str, ...]:
    return tuple(e.spec.lattice for e in plan.entries)


def merge_trees(names: tuple[str, ...], a: Any, b: Any) -> Any:
    """Merge two state trees whose logical groups align with ``names``."""
    return lattice.tree_join_flat(names, a, b)


def merge_many(names: tuple[str, ...], states: Sequence[Any]) -> Any:
    """Fold ⊔ over many states as a balanced tree reduction (log depth,
    the anti-entropy topology a deployment would use); associativity
    makes the order free."""
    states = list(states)
    if not states:
        raise ValueError("nothing to merge")
    while len(states) > 1:
        nxt = [merge_trees(names, states[i], states[i + 1])
               for i in range(0, len(states) - 1, 2)]
        if len(states) % 2:
            nxt.append(states[-1])
        states = nxt
    return states[0]


def merge_versioned_fused(a: VersionedSlots, b: VersionedSlots,
                          lo: float = float("-inf"),
                          hi: float = float("inf")
                          ) -> tuple[VersionedSlots, torch.Tensor]:
    """The VersionedSlots join and the threshold audit in one pass (kernel
    B4 on the card, its plain version on the CPU). Returns (merged
    VersionedSlots, violation mask): a valid merged row with any payload
    element outside ``[lo, hi]``, compared in the payload's dtype.

    The stamps go to the kernel as they are (int64 for the port's tables):
    the reference casts them to int32 first, which under x64 truncates
    stamps of 2**31 and above."""
    valid, version, payload, viol = kops.lattice_merge(
        a.valid, a.version, a.payload, b.valid, b.version, b.payload,
        lo=lo, hi=hi)
    return VersionedSlots(valid, version, payload), viol


def _leaf_agrees(u, v, atol: float) -> bool:
    u, v = torch.as_tensor(u), torch.as_tensor(v)
    if not u.is_floating_point():   # bool and integer leaves: exactly
        return torch.equal(u, v)
    return torch.allclose(u, v, atol=atol)


def converged(names: tuple[str, ...], states: Sequence[Any],
              atol: float = 0.0) -> bool:
    """Definition 3 check: after pairwise exchange, do replicas agree?
    Bool and integer leaves exactly, float leaves within ``allclose``
    (``atol``, the default ``rtol``), as in the reference."""
    target = merge_many(names, states)
    t_leaves = tree.leaves(target)
    for s in states:
        merged = tree.leaves(merge_trees(names, s, target))
        if not all(_leaf_agrees(u, v, atol)
                   for u, v in zip(merged, t_leaves)):
            return False
    return True
