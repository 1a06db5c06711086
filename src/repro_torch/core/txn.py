"""Transaction model — ``T : DB -> DB`` (paper §3).

A transaction is (statically) a set of :class:`Op` descriptors the analyzer
reasons about, and (dynamically) an optional executable closure used by the
witness machinery and the runtime. Ops mirror the operation column of the
paper's Table 2.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional, Sequence


class OpKind(enum.Enum):
    READ = "read"                        # selection
    INSERT = "insert"                    # add a record / add to set
    DELETE = "delete"                    # naive delete (tombstone)
    CASCADING_DELETE = "cascading_delete"
    UPDATE = "update"                    # modify an existing record in place
    INCREMENT = "increment"              # ADT counter +=
    DECREMENT = "decrement"              # ADT counter -=
    ASSIGN_SPECIFIC = "assign_specific"  # "grant this record THIS unique id"
    ASSIGN_SOME = "assign_some"          # "grant this record SOME unique id"
    LIST_MUTATE = "list_mutate"          # list append/prepend/remove
    MERGE_VIEW = "merge_view"            # maintain materialized view alongside base


@dataclasses.dataclass(frozen=True)
class Op:
    """One operation on one state element.

    Attributes:
      kind: operation taxonomy entry.
      target: state element acted on ("table.column" / state-tree leaf path).
        The analyzer matches ``target`` prefixes against invariant targets.
      params: op-specific info (e.g. amount sign known statically).
    """

    kind: OpKind
    target: str = ""
    params: dict = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        tgt = f" {self.target}" if self.target else ""
        return f"{self.kind.value}{tgt}"


@dataclasses.dataclass(frozen=True)
class Transaction:
    """A named group of ops executed atomically on one replica.

    ``apply`` (optional) is the executable form: ``apply(state, **kwargs) ->
    new_state`` — pure, so replicas can run it against a local copy, check
    invariants, and commit or abort (paper Definition 2: transactional
    availability admits only self-aborts and invariant-violation aborts).
    """

    name: str
    ops: tuple[Op, ...]
    apply: Optional[Callable[..., Any]] = None

    def targets(self) -> set[str]:
        return {op.target for op in self.ops if op.target}


def txn(name: str, *ops: Op, apply: Callable | None = None) -> Transaction:
    return Transaction(name, tuple(ops), apply)


# -- op constructors --------------------------------------------------------

def read(target: str = "") -> Op:
    return Op(OpKind.READ, target)


def insert(target: str) -> Op:
    return Op(OpKind.INSERT, target)


def delete(target: str, cascading: bool = False) -> Op:
    return Op(OpKind.CASCADING_DELETE if cascading else OpKind.DELETE, target)


def update(target: str) -> Op:
    return Op(OpKind.UPDATE, target)


def increment(target: str, amount: float | None = None) -> Op:
    return Op(OpKind.INCREMENT, target, {"amount": amount} if amount is not None else {})


def decrement(target: str, amount: float | None = None) -> Op:
    return Op(OpKind.DECREMENT, target, {"amount": amount} if amount is not None else {})


def assign_specific(target: str) -> Op:
    return Op(OpKind.ASSIGN_SPECIFIC, target)


def assign_some(target: str) -> Op:
    return Op(OpKind.ASSIGN_SOME, target)


def list_mutate(target: str) -> Op:
    return Op(OpKind.LIST_MUTATE, target)


def merge_view(target: str, source: str) -> Op:
    return Op(OpKind.MERGE_VIEW, target, {"source": source})


# ---------------------------------------------------------------------------
# Valid sequences (paper Definition 6): execute transactions in turn against a
# local copy, aborting (skipping) any whose post-state is invalid. Used by the
# witness machinery and the coordination-free executor.
# ---------------------------------------------------------------------------


def run_valid_sequence(state: Any,
                       transactions: Sequence[Transaction],
                       invariants: Sequence,
                       txn_kwargs: Sequence[dict] | None = None) -> tuple[Any, list[bool]]:
    """Apply transactions in order, committing only I-valid post-states.

    Returns (final_state, committed_flags). This is exactly the construction
    in the ⇐ direction of Theorem 1's proof: "each replica executes the
    transactions it receives against a copy of its current state and checks
    whether or not the resulting state is I-valid."
    """
    committed = []
    kwargs_list = txn_kwargs or [{}] * len(transactions)
    for t, kw in zip(transactions, kwargs_list):
        if t.apply is None:
            raise ValueError(f"transaction {t.name!r} is not executable")
        candidate = t.apply(state, **kw)
        ok = all(inv.check(candidate) for inv in invariants if inv.predicate is not None)
        if ok:
            state = candidate
            committed.append(True)
        else:
            committed.append(False)  # abort: discard candidate state
    return state, committed
