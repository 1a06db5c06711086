"""Rule-based I-confluence analyzer (paper §5, Table 2).

Given (invariant kind, operation kind), decide whether concurrent,
coordination-free execution on divergent replicas followed by merge can
violate the invariant. The rules reproduce the paper's Table 2 exactly
(benchmarks/table2.py diffs our output against the table), and extend it with
the *mitigation strategies* the paper describes in prose:

* non-confluent uniqueness via ASSIGN_SOME -> replica-namespaced generation
  ("grant this record some unique ID", §5.1) is confluent;
* non-confluent threshold decrements -> ESCROW partitioning (§8);
* AUTO_INCREMENT -> deferred commit-time assignment against a single atomic
  counter (§6.2, TPC-C district IDs).

The output of analysis is consumed by core/planner.py to build the runtime
coordination plan.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

from .invariants import Invariant, InvariantKind
from .txn import Op, OpKind, Transaction


class Confluence(enum.Enum):
    CONFLUENT = "confluent"            # coordination-free (Theorem 1 ⇐)
    NOT_CONFLUENT = "not_confluent"    # must coordinate (Theorem 1 ⇒)


class Strategy(enum.Enum):
    """How to execute the pair at scale."""

    NONE = "none"                          # plain local execution; async merge
    LOCAL_CHECK = "local_check"            # local invariant check suffices
    REPLICA_NAMESPACE = "replica_namespace"  # unique IDs from disjoint namespaces
    ESCROW = "escrow"                      # pre-partitioned budget (amortized coord)
    DEFERRED_ASSIGNMENT = "deferred_assignment"  # temp ID now, sequential ID at commit
    SYNC_COORDINATION = "sync_coordination"      # synchronous mutual exclusion


@dataclasses.dataclass(frozen=True)
class Verdict:
    confluent: Confluence
    strategy: Strategy
    reason: str

    @property
    def coordination_free(self) -> bool:
        return self.confluent is Confluence.CONFLUENT

    def __str__(self) -> str:
        return f"{self.confluent.value} [{self.strategy.value}]: {self.reason}"


def _v(conf: Confluence, strat: Strategy, reason: str) -> Verdict:
    return Verdict(conf, strat, reason)


CONFLUENT = Confluence.CONFLUENT
NOT_CONFLUENT = Confluence.NOT_CONFLUENT


# ---------------------------------------------------------------------------
# The pairwise rule table. classify() is the paper's Table 2; rows not in the
# table fall back to conservative NOT_CONFLUENT (the paper: conservative
# analysis without full invariant specification "will result in less useful
# results" — never unsafe ones).
# ---------------------------------------------------------------------------


def classify(invariant: Invariant, op: Op) -> Verdict:
    """Classify one (invariant, operation) pair."""
    k, o = invariant.kind, op.kind

    # Reads never mutate state: trivially confluent under any invariant.
    if o is OpKind.READ:
        return _v(CONFLUENT, Strategy.NONE, "reads do not mutate state")

    if k is InvariantKind.EQUALITY:
        return _v(CONFLUENT, Strategy.LOCAL_CHECK,
                  "per-record equality: non-destructive merge cannot alter a "
                  "record's value, so any violating record must already "
                  "violate I on some replica (paper §5.1 proof)")

    if k is InvariantKind.INEQUALITY:
        return _v(CONFLUENT, Strategy.LOCAL_CHECK,
                  "per-record inequality (e.g. NOT NULL): same argument as "
                  "equality — merge introduces no new per-record values")

    if k is InvariantKind.UNIQUENESS:
        if o in (OpKind.DELETE, OpKind.CASCADING_DELETE):
            return _v(CONFLUENT, Strategy.NONE,
                      "removing items cannot introduce duplicates")
        if o is OpKind.ASSIGN_SPECIFIC or o is OpKind.INSERT or o is OpKind.UPDATE:
            return _v(NOT_CONFLUENT, Strategy.SYNC_COORDINATION,
                      "two replicas can pick the same specific value "
                      "({Stan:5} ⊔ {Mary:5} — paper §5.1)")
        if o is OpKind.ASSIGN_SOME:
            return _v(CONFLUENT, Strategy.REPLICA_NAMESPACE,
                      "'grant SOME unique id': replicas draw from disjoint "
                      "namespaces (replica-id ⊕ sequence), merges stay unique")

    if k is InvariantKind.AUTO_INCREMENT:
        if o in (OpKind.INSERT, OpKind.ASSIGN_SPECIFIC, OpKind.ASSIGN_SOME):
            return _v(NOT_CONFLUENT, Strategy.DEFERRED_ASSIGNMENT,
                      "dense sequential IDs admit no gaps: concurrent inserts "
                      "collide or leave holes; mitigate via commit-time "
                      "assignment against one atomic counter (TPC-C §6.2)")
        if o in (OpKind.DELETE, OpKind.CASCADING_DELETE):
            return _v(NOT_CONFLUENT, Strategy.DEFERRED_ASSIGNMENT,
                      "deletion from a dense sequence leaves gaps; same "
                      "deferred strategy applies (order Delivery)")

    if k is InvariantKind.FOREIGN_KEY:
        if o in (OpKind.INSERT, OpKind.UPDATE):
            return _v(CONFLUENT, Strategy.LOCAL_CHECK,
                      "non-destructive merge cannot make referenced tuples "
                      "disappear; insertion preserves referential integrity "
                      "(paper §5.1)")
        if o is OpKind.DELETE:
            return _v(NOT_CONFLUENT, Strategy.SYNC_COORDINATION,
                      "naive delete can strand references inserted "
                      "concurrently on another replica")
        if o is OpKind.CASCADING_DELETE:
            return _v(CONFLUENT, Strategy.NONE,
                      "cascading delete removes dangling references on merge "
                      "(2P-set tombstones propagate monotonically)")

    if k in (InvariantKind.SECONDARY_INDEX, InvariantKind.MATERIALIZED_VIEW):
        return _v(CONFLUENT, Strategy.LOCAL_CHECK,
                  "view/index reflects primary data: updates install "
                  "atomically with base data; merge has no conflicts "
                  "(paper §5.1 Materialized Views)")

    if k is InvariantKind.GREATER_THAN:
        if o in (OpKind.INCREMENT, OpKind.UPDATE, OpKind.INSERT):
            return _v(CONFLUENT, Strategy.LOCAL_CHECK,
                      "increments only move value away from the lower bound; "
                      "merged counters reflect all increments (§5.2)")
        if o is OpKind.DECREMENT:
            return _v(NOT_CONFLUENT, Strategy.ESCROW,
                      "concurrent decrements can jointly cross the floor "
                      "(two $-200 withdrawals from $300); escrow shares make "
                      "the hot path local (§8)")

    if k is InvariantKind.LESS_THAN:
        if o in (OpKind.DECREMENT, OpKind.UPDATE, OpKind.INSERT):
            return _v(CONFLUENT, Strategy.LOCAL_CHECK,
                      "decrements only move value away from the upper bound")
        if o is OpKind.INCREMENT:
            return _v(NOT_CONFLUENT, Strategy.ESCROW,
                      "concurrent increments can jointly cross the ceiling; "
                      "escrow the headroom (§8)")

    if k is InvariantKind.CONTAINS:
        return _v(CONFLUENT, Strategy.LOCAL_CHECK,
                  "[NOT] CONTAINS over sets/lists/maps: membership after "
                  "union merge is the union of memberships; per-replica "
                  "checks suffice (Table 2)")

    if k is InvariantKind.LIST_POSITION:
        if o in (OpKind.LIST_MUTATE, OpKind.INSERT, OpKind.DELETE,
                 OpKind.CASCADING_DELETE, OpKind.UPDATE):
            return _v(NOT_CONFLUENT, Strategy.SYNC_COORDINATION,
                      "HEAD=/TAIL=/length= depend on global order/cardinality "
                      "which merge perturbs (Table 2)")

    if k is InvariantKind.CUSTOM:
        return _v(NOT_CONFLUENT, Strategy.SYNC_COORDINATION,
                  "no static rule for custom invariants: conservative "
                  "(run witness search for evidence)")

    # Fallback: ops that cannot affect this invariant kind.
    return _v(CONFLUENT, Strategy.NONE,
              f"{o.value} cannot affect {k.value} (disjoint semantics)")


# ---------------------------------------------------------------------------
# Transaction- and application-level analysis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PairReport:
    invariant: Invariant
    op: Op
    verdict: Verdict


@dataclasses.dataclass(frozen=True)
class TxnReport:
    """Analysis of one transaction against a set of invariants."""

    transaction: Transaction
    pairs: tuple[PairReport, ...]

    @property
    def coordination_free(self) -> bool:
        return all(p.verdict.coordination_free for p in self.pairs)

    @property
    def required_strategies(self) -> tuple[Strategy, ...]:
        out = []
        for p in self.pairs:
            s = p.verdict.strategy
            if s not in (Strategy.NONE, Strategy.LOCAL_CHECK) and s not in out:
                out.append(s)
        return tuple(out)

    def blocking_pairs(self) -> tuple[PairReport, ...]:
        return tuple(p for p in self.pairs if not p.verdict.coordination_free)

    def summary(self) -> str:
        status = "coordination-FREE" if self.coordination_free else "requires coordination"
        lines = [f"{self.transaction.name}: {status}"]
        for p in self.pairs:
            mark = "✓" if p.verdict.coordination_free else "✗"
            lines.append(f"  {mark} {p.op.describe()} × {p.invariant.name}"
                         f" -> {p.verdict}")
        return "\n".join(lines)


def _relevant(inv: Invariant, op: Op) -> bool:
    """Does this op's target touch this invariant's target (or either is global)?

    Matching is prefix-based on dotted paths: op on ``employees`` touches
    invariant on ``employees.id``; FK invariants also watch their referenced
    table (deleting a referenced department matters to employees.dept).
    """
    if not inv.target or not op.target:
        return True
    a, b = inv.target, op.target
    if a.startswith(b) or b.startswith(a):
        return True
    if inv.kind is InvariantKind.FOREIGN_KEY:
        ref = inv.params.get("references", "")
        if ref and (ref.startswith(op.target) or op.target.startswith(ref.split(".")[0])):
            return True
    if inv.kind is InvariantKind.MATERIALIZED_VIEW:
        src = inv.params.get("source", "")
        if src and (src.startswith(op.target) or op.target.startswith(src.split(".")[0])):
            return True
    return False


def analyze_transaction(transaction: Transaction,
                        invariants: Sequence[Invariant]) -> TxnReport:
    """A transaction is I-confluent iff every relevant (inv, op) pair is.

    This conjunction is sound: merge anomalies arise per state element, and a
    transaction whose every op is safe w.r.t. every invariant admits no
    violating diamond (the witness suite cross-validates this empirically).
    """
    pairs = []
    for op in transaction.ops:
        for inv in invariants:
            if _relevant(inv, op):
                pairs.append(PairReport(inv, op, classify(inv, op)))
    return TxnReport(transaction, tuple(pairs))


def analyze_application(transactions: Sequence[Transaction],
                        invariants: Sequence[Invariant]) -> dict[str, TxnReport]:
    """Whole-application analysis: the paper's 'potential scalability' test."""
    return {t.name: analyze_transaction(t, invariants) for t in transactions}


# ---------------------------------------------------------------------------
# Table 2 reproduction — every row of the paper's table, in order.
# ---------------------------------------------------------------------------

TABLE2_ROWS: tuple[tuple[str, InvariantKind, str, OpKind, bool], ...] = (
    # (invariant label, kind, operation label, op kind, paper says confluent?)
    ("Equality", InvariantKind.EQUALITY, "Any", OpKind.UPDATE, True),
    ("Inequality", InvariantKind.INEQUALITY, "Any", OpKind.UPDATE, True),
    ("Uniqueness", InvariantKind.UNIQUENESS, "Choose specific value", OpKind.ASSIGN_SPECIFIC, False),
    ("Uniqueness", InvariantKind.UNIQUENESS, "Choose some value", OpKind.ASSIGN_SOME, True),
    ("AUTO_INCREMENT", InvariantKind.AUTO_INCREMENT, "Insert", OpKind.INSERT, False),
    ("Foreign Key", InvariantKind.FOREIGN_KEY, "Insert", OpKind.INSERT, True),
    ("Foreign Key", InvariantKind.FOREIGN_KEY, "Delete", OpKind.DELETE, False),
    ("Foreign Key", InvariantKind.FOREIGN_KEY, "Cascading Delete", OpKind.CASCADING_DELETE, True),
    ("Secondary Indexing", InvariantKind.SECONDARY_INDEX, "Update", OpKind.UPDATE, True),
    ("Materialized Views", InvariantKind.MATERIALIZED_VIEW, "Update", OpKind.UPDATE, True),
    (">", InvariantKind.GREATER_THAN, "Increment [Counter]", OpKind.INCREMENT, True),
    ("<", InvariantKind.LESS_THAN, "Decrement [Counter]", OpKind.DECREMENT, True),
    (">", InvariantKind.GREATER_THAN, "Decrement [Counter]", OpKind.DECREMENT, False),
    ("<", InvariantKind.LESS_THAN, "Increment [Counter]", OpKind.INCREMENT, False),
    ("[NOT] CONTAINS", InvariantKind.CONTAINS, "Any [Set, List, Map]", OpKind.INSERT, True),
    ("HEAD=,TAIL=,length=", InvariantKind.LIST_POSITION, "Mutation [List]", OpKind.LIST_MUTATE, False),
)


def table2() -> list[dict]:
    """Run the analyzer over every Table-2 row; used by tests & benchmark."""
    out = []
    for label, kind, op_label, op_kind, expected in TABLE2_ROWS:
        inv = Invariant(label, kind)
        v = classify(inv, Op(op_kind))
        out.append({
            "invariant": label,
            "operation": op_label,
            "paper": expected,
            "analyzer": v.coordination_free,
            "match": v.coordination_free == expected,
            "strategy": v.strategy.value,
        })
    return out
