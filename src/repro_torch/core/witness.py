"""Theorem-1 witness machinery: executable diamond diagrams (paper Fig. 2).

The analyzer (analyzer.py) gives *static* verdicts; this module provides the
*dynamic* evidence:

* ⇐ direction: for pairs the analyzer marks CONFLUENT, randomized diamond
  executions — two I-valid sequences from a common ancestor, merged — must
  always produce I-valid state. (tests/test_theorem1.py runs thousands.)
* ⇒ direction: for pairs marked NOT_CONFLUENT, a witness search must find a
  concrete diamond whose merge violates the invariant — the execution α3 in
  the paper's proof, demonstrating that any coordination-free, available,
  convergent system would install an invalid state.

Both run on concrete replicated systems defined in core/systems.py.

The port's copy of ``repro.core.witness`` (numpy, like the reference; the
port keeps its own because importing the reference's runs
``repro/core/__init__.py``, which imports jax). Only
:func:`check_convergence` differs: it flattens states with the port's own
``core/tree.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np

from . import tree
from .invariants import Invariant
from .txn import Transaction, run_valid_sequence


@dataclasses.dataclass
class DiamondResult:
    """One executed diamond: Ds -> (S1, S2) -> merge."""

    ancestor: Any
    left_state: Any
    right_state: Any
    merged: Any
    left_committed: list
    right_committed: list
    merged_valid: bool
    left_txns: list
    right_txns: list

    def describe(self) -> str:
        l = ", ".join(t.name for t in self.left_txns) or "(empty)"
        r = ", ".join(t.name for t in self.right_txns) or "(empty)"
        return (f"diamond: S1=[{l}] S2=[{r}] -> merge "
                f"{'I-valid' if self.merged_valid else 'INVALID'}")


@dataclasses.dataclass
class ReplicatedSystem:
    """A concrete (D0, T, I, ⊔) instance for witness execution.

    Attributes:
      name: label.
      initial_state: D0 (must be I-valid).
      txn_pool: factory ``rng -> (Transaction, kwargs)`` producing a random
        concrete transaction instance (the set T with randomized parameters).
      invariants: executable invariants.
      merge: the ⊔ operator over two states.
      equal: state equality (for convergence checks); default pytree-equal.
      bind_branch: optional ``(kwargs, branch_id) -> kwargs`` rebinding a
        transaction instance to the replica executing it. In the paper's model
        each diamond branch IS a distinct replica — systems whose state has
        per-replica slots (G-counters, escrow shares, ID namespaces) must bind
        the executing replica to the branch, otherwise two branches would
        write the same slot, which no real replica pair can do.
    """

    name: str
    initial_state: Any
    txn_pool: Callable[[np.random.Generator], tuple[Transaction, dict]]
    invariants: Sequence[Invariant]
    merge: Callable[[Any, Any], Any]
    equal: Optional[Callable[[Any, Any], bool]] = None
    bind_branch: Optional[Callable[[dict, int], dict]] = None

    def check(self, state: Any) -> bool:
        return all(inv.check(state) for inv in self.invariants
                   if inv.predicate is not None)


def _draw_sequence(system: ReplicatedSystem, rng: np.random.Generator,
                   max_len: int) -> tuple[list[Transaction], list[dict]]:
    n = int(rng.integers(0, max_len + 1))
    txns, kwargs = [], []
    for _ in range(n):
        t, kw = system.txn_pool(rng)
        txns.append(t)
        kwargs.append(kw)
    return txns, kwargs


def run_diamond(system: ReplicatedSystem, rng: np.random.Generator,
                max_seq_len: int = 4, setup_len: int = 2) -> DiamondResult:
    """Execute one randomized diamond (paper Fig. 2).

    D0 --S0--> Ds, then S1 and S2 run *independently* (each a valid sequence —
    invalid transactions abort locally, Definition 2), and the divergent
    states merge. The result records whether the merged state is I-valid.
    """
    if not system.check(system.initial_state):
        raise ValueError(f"{system.name}: initial state is not I-valid")

    def bind(kwargs_list, branch):
        if system.bind_branch is None:
            return kwargs_list
        return [system.bind_branch(kw, branch) for kw in kwargs_list]

    # Common ancestor Ds = S0(D0): a valid sequence from the initial state
    # (executed on replica 0; its effects are shared history by merge time).
    setup_txns, setup_kwargs = _draw_sequence(system, rng, setup_len)
    ancestor, _ = run_valid_sequence(system.initial_state, setup_txns,
                                     system.invariants, bind(setup_kwargs, 0))

    left_txns, left_kwargs = _draw_sequence(system, rng, max_seq_len)
    right_txns, right_kwargs = _draw_sequence(system, rng, max_seq_len)
    left_kwargs = bind(left_kwargs, 0)
    right_kwargs = bind(right_kwargs, 1)

    left, lc = run_valid_sequence(ancestor, left_txns, system.invariants, left_kwargs)
    right, rc = run_valid_sequence(ancestor, right_txns, system.invariants, right_kwargs)

    merged = system.merge(left, right)
    return DiamondResult(ancestor, left, right, merged, lc, rc,
                         system.check(merged),
                         [t for t, c in zip(left_txns, lc) if c],
                         [t for t, c in zip(right_txns, rc) if c])


def search_witness(system: ReplicatedSystem, seed: int = 0,
                   max_trials: int = 2000, max_seq_len: int = 4) -> Optional[DiamondResult]:
    """Search for a violating diamond (evidence of non-I-confluence).

    Returns the first DiamondResult whose merge is invalid, or None if no
    witness was found within the budget. Finding one proves NOT_CONFLUENT;
    not finding one is (only) statistical evidence of confluence — the static
    analyzer supplies the proof-side reasoning.
    """
    rng = np.random.default_rng(seed)
    for _ in range(max_trials):
        d = run_diamond(system, rng, max_seq_len=max_seq_len)
        if not d.merged_valid:
            return d
    return None


def check_confluence_empirically(system: ReplicatedSystem, seed: int = 0,
                                 trials: int = 500, max_seq_len: int = 4) -> dict:
    """Run many diamonds; report the violation rate (0.0 for confluent systems)."""
    rng = np.random.default_rng(seed)
    violations = 0
    commits = 0
    for _ in range(trials):
        d = run_diamond(system, rng, max_seq_len=max_seq_len)
        violations += 0 if d.merged_valid else 1
        commits += sum(d.left_committed) + sum(d.right_committed)
    return {"system": system.name, "trials": trials,
            "violations": violations, "committed_txns": commits,
            "violation_rate": violations / max(trials, 1)}


def check_convergence(system: ReplicatedSystem, seed: int = 0,
                      trials: int = 100, max_seq_len: int = 4) -> bool:
    """Definition 3: merge order must not matter — ⊔ is ACI over reachable states.

    Executes three divergent branches and verifies
    merge(merge(a,b),c) == merge(a, merge(b,c)) == merge(merge(c,a),b).
    """
    def eq(x, y):
        if system.equal is not None:
            return system.equal(x, y)
        lx, ly = tree.leaves(x), tree.leaves(y)
        return all(np.array_equal(np.asarray(u), np.asarray(v)) for u, v in zip(lx, ly))

    rng = np.random.default_rng(seed)
    for _ in range(trials):
        branches = []
        for b in range(3):
            txns, kwargs = _draw_sequence(system, rng, max_seq_len)
            if system.bind_branch is not None:
                kwargs = [system.bind_branch(kw, b) for kw in kwargs]
            st, _ = run_valid_sequence(system.initial_state, txns,
                                       system.invariants, kwargs)
            branches.append(st)
        a, b, c = branches
        m1 = system.merge(system.merge(a, b), c)
        m2 = system.merge(a, system.merge(b, c))
        m3 = system.merge(system.merge(c, a), b)
        if not (eq(m1, m2) and eq(m2, m3)):
            return False
    return True
