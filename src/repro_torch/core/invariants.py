"""Invariant model — ``I : DB -> {true, false}`` (paper §3, Definition 1).

An :class:`Invariant` couples

* a **declarative kind** (the SQL-ish taxonomy of paper §5 / Table 2) that the
  rule-based analyzer reasons about *statically*, and
* an optional **executable predicate** over concrete state used by the
  Theorem-1 witness machinery (core/witness.py) and the runtime's local
  validity check (a transactionally-available replica aborts a transaction
  whose post-state is invalid — paper Definition 2).

Invariants never reference other replicas: they are predicates over a single
(replica's) database state, which is exactly what makes local checking
coordination-free.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional, Sequence


class InvariantKind(enum.Enum):
    """Rows of the paper's Table 2 (plus the generic CUSTOM escape hatch)."""

    EQUALITY = "equality"                    # per-record value equality (incl. NOT NULL)
    INEQUALITY = "inequality"                # per-record value inequality
    UNIQUENESS = "uniqueness"                # primary key / unique column
    AUTO_INCREMENT = "auto_increment"        # dense sequential IDs, no gaps
    FOREIGN_KEY = "foreign_key"              # referential integrity
    SECONDARY_INDEX = "secondary_index"      # index reflects base table
    MATERIALIZED_VIEW = "materialized_view"  # view reflects primary data
    GREATER_THAN = "greater_than"            # row value > threshold (ADT counter)
    LESS_THAN = "less_than"                  # row value < threshold (ADT counter)
    CONTAINS = "contains"                    # [NOT] CONTAINS over set/list/map
    LIST_POSITION = "list_position"          # HEAD= / TAIL= / length=
    CUSTOM = "custom"                        # executable-only invariant


@dataclasses.dataclass(frozen=True)
class Invariant:
    """A named application-level correctness predicate.

    Attributes:
      name: human-readable identifier (e.g. ``"employee_id_unique"``).
      kind: static taxonomy entry driving analyzer rules.
      target: the state element (table.column / state-tree leaf path) the
        invariant constrains. Purely informational for the analyzer; used by
        the planner to associate invariants with state leaves.
      predicate: optional executable check ``state -> bool`` (numpy/torch).
      params: kind-specific parameters (e.g. threshold for GREATER_THAN,
        referenced table for FOREIGN_KEY).
    """

    name: str
    kind: InvariantKind
    target: str = ""
    predicate: Optional[Callable[[Any], Any]] = None
    params: dict = dataclasses.field(default_factory=dict)

    def check(self, state: Any) -> bool:
        if self.predicate is None:
            raise ValueError(f"invariant {self.name!r} has no executable predicate")
        return bool(self.predicate(state))

    def describe(self) -> str:
        extra = f" {self.params}" if self.params else ""
        tgt = f" on {self.target}" if self.target else ""
        return f"{self.name}: {self.kind.value}{tgt}{extra}"


# ---------------------------------------------------------------------------
# Convenience constructors mirroring SQL DDL (paper: "e.g., via schema
# annotations")
# ---------------------------------------------------------------------------


def not_null(name: str, target: str, predicate: Callable | None = None) -> Invariant:
    return Invariant(name, InvariantKind.EQUALITY, target, predicate,
                     {"constraint": "NOT NULL"})


def unique(name: str, target: str, predicate: Callable | None = None) -> Invariant:
    return Invariant(name, InvariantKind.UNIQUENESS, target, predicate)


def auto_increment(name: str, target: str, predicate: Callable | None = None) -> Invariant:
    return Invariant(name, InvariantKind.AUTO_INCREMENT, target, predicate)


def foreign_key(name: str, target: str, references: str,
                on_delete: str = "restrict",
                predicate: Callable | None = None) -> Invariant:
    if on_delete not in ("restrict", "cascade"):
        raise ValueError("on_delete must be 'restrict' or 'cascade'")
    return Invariant(name, InvariantKind.FOREIGN_KEY, target, predicate,
                     {"references": references, "on_delete": on_delete})


def greater_than(name: str, target: str, threshold: float,
                 predicate: Callable | None = None) -> Invariant:
    return Invariant(name, InvariantKind.GREATER_THAN, target, predicate,
                     {"threshold": threshold})


def less_than(name: str, target: str, threshold: float,
              predicate: Callable | None = None) -> Invariant:
    return Invariant(name, InvariantKind.LESS_THAN, target, predicate,
                     {"threshold": threshold})


def materialized_view(name: str, target: str, source: str,
                      predicate: Callable | None = None) -> Invariant:
    return Invariant(name, InvariantKind.MATERIALIZED_VIEW, target, predicate,
                     {"source": source})


def contains(name: str, target: str, negated: bool = False,
             predicate: Callable | None = None) -> Invariant:
    return Invariant(name, InvariantKind.CONTAINS, target, predicate,
                     {"negated": negated})


def custom(name: str, predicate: Callable, target: str = "") -> Invariant:
    return Invariant(name, InvariantKind.CUSTOM, target, predicate)


# ---------------------------------------------------------------------------
# The running payroll example from paper §2 — used across tests and the
# quickstart example.
# ---------------------------------------------------------------------------


def payroll_invariants() -> Sequence[Invariant]:
    """IDs unique; employee.dept references departments; salary <= 50k."""
    return (
        unique("employee_id_unique", "employees.id"),
        foreign_key("employee_dept_fk", "employees.dept", references="departments.id"),
        less_than("salary_cap", "employees.salary", 50_001.0),
    )
