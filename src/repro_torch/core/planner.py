"""Coordination planner — the paper's analysis applied to a runtime state tree.

This is what makes coordination avoidance a *first-class framework feature*
rather than a database-only result: every mutable element of the training or
serving runtime (gradient accumulators, optimizer moments, step counters,
metric counters, data cursors, loss scale, ID allocators, checkpoint
manifests) is registered as a :class:`StateSpec` — (lattice, ops, invariants).
The planner runs the I-confluence analyzer over each spec and classifies it:

  COORDINATION_FREE  -> updated locally per replica; reconciled by an
                        asynchronous/deferred merge (paper Fig. 1);
  ESCROW             -> non-confluent but amortizable via pre-partitioned
                        budgets (paper §8);
  COORDINATION_REQUIRED -> a synchronous collective on the critical path.

The port's copy: ``repro_torch.txn.engine.Engine`` consumes the plan to pick
its stock regime, the serving runtime (``repro_torch.runtime.serve``)
prints its plan from :func:`serving_state_specs`, and the training runtime
(``repro_torch.runtime.train``) refuses a configuration its plan from
:func:`training_state_specs` marks unsafe.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

from .analyzer import Strategy, Verdict, classify
from .invariants import Invariant, InvariantKind
from .txn import Op, OpKind


class CoordClass(enum.Enum):
    FREE = "coordination_free"
    ESCROW = "escrow"
    REQUIRED = "coordination_required"


@dataclasses.dataclass(frozen=True)
class StateSpec:
    """One leaf (or leaf group) of the runtime state tree.

    Attributes:
      name: dotted path in the state tree (e.g. "optim.moments.mu").
      lattice: registered lattice name used for merging this leaf
        (see core/lattice.py registry). "sum" marks delta-merge leaves.
      ops: the operations the runtime performs on the leaf each step.
      invariants: application-level invariants constraining the leaf.
      merge_every: for FREE leaves, how many local steps between merges
        (1 = merge each step; k>1 = deferred/local-SGD style; 0 = only at
        epoch/log/checkpoint boundaries).
      note: free-form documentation.
    """

    name: str
    lattice: str
    ops: tuple[Op, ...]
    invariants: tuple[Invariant, ...] = ()
    merge_every: int = 1
    note: str = ""


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    spec: StateSpec
    coord_class: CoordClass
    verdicts: tuple[tuple[str, str, Verdict], ...]  # (inv, op, verdict)
    strategy: Strategy

    def describe(self) -> str:
        return (f"{self.spec.name:32s} {self.coord_class.value:24s} "
                f"strategy={self.strategy.value:20s} merge={self.spec.lattice}"
                f"/every={self.spec.merge_every}")


@dataclasses.dataclass(frozen=True)
class CoordinationPlan:
    entries: tuple[PlanEntry, ...]

    def by_class(self, c: CoordClass) -> tuple[PlanEntry, ...]:
        return tuple(e for e in self.entries if e.coord_class is c)

    @property
    def free(self) -> tuple[PlanEntry, ...]:
        return self.by_class(CoordClass.FREE)

    @property
    def escrow(self) -> tuple[PlanEntry, ...]:
        return self.by_class(CoordClass.ESCROW)

    @property
    def required(self) -> tuple[PlanEntry, ...]:
        return self.by_class(CoordClass.REQUIRED)

    def entry(self, name: str) -> PlanEntry:
        for e in self.entries:
            if e.spec.name == name:
                return e
        raise KeyError(name)

    def summary(self) -> str:
        lines = [f"coordination plan: {len(self.free)} free / "
                 f"{len(self.escrow)} escrow / {len(self.required)} required"]
        for e in self.entries:
            lines.append("  " + e.describe())
        return "\n".join(lines)

    def critical_path_collectives(self) -> tuple[str, ...]:
        """Names of leaves that demand a synchronous collective every step."""
        return tuple(e.spec.name for e in self.required) + tuple(
            e.spec.name for e in self.free
            if e.spec.merge_every == 1 and e.spec.lattice == "sum")


def plan_state(spec: StateSpec) -> PlanEntry:
    """Classify one state leaf via the I-confluence analyzer."""
    verdicts = []
    worst: Optional[Verdict] = None
    for op in spec.ops:
        for inv in spec.invariants:
            v = classify(inv, op)
            verdicts.append((inv.name, op.kind.value, v))
            if not v.coordination_free:
                if worst is None or v.strategy is Strategy.SYNC_COORDINATION:
                    worst = v

    if worst is None:
        coord = CoordClass.FREE
        strategy = Strategy.NONE if not verdicts else verdicts[0][2].strategy
    elif worst.strategy in (Strategy.ESCROW, Strategy.DEFERRED_ASSIGNMENT):
        coord = CoordClass.ESCROW
        strategy = worst.strategy
    else:
        coord = CoordClass.REQUIRED
        strategy = Strategy.SYNC_COORDINATION
    return PlanEntry(spec, coord, tuple(verdicts), strategy)


def plan_states(specs: Sequence[StateSpec]) -> CoordinationPlan:
    return CoordinationPlan(tuple(plan_state(s) for s in specs))


def plan(specs: Sequence[StateSpec]) -> CoordinationPlan:
    """The planner's public entry point: classify every declared state
    element and return the CoordinationPlan a runtime consumes to choose its
    per-element execution regime (repro_torch.txn.engine.Engine does this
    at construction: FREE -> local merge path, ESCROW -> pre-partitioned
    shares with amortized refresh, REQUIRED -> the synchronous 2PC engine).
    """
    return plan_states(specs)


def _inv(name, kind, target="", params=None):
    return Invariant(name, kind, target, None, params or {})


def training_state_specs(*, coord_mode: str = "hierarchical",
                         merge_every: int = 8,
                         exact_clip: bool = False) -> list[StateSpec]:
    """State specs for the LM training loop.

    coord_mode:
      "sync"         -> gradients merge every step (paper-faithful
                        "serializable" analog: max coordination);
      "hierarchical" -> intra-pod merge each step, cross-pod merge deferred
                        ``merge_every`` steps;
      "local_sgd"    -> fully deferred merge every ``merge_every`` steps.
    exact_clip: True -> global-norm clipping needs a synchronous all-reduce
                        (COORDINATION_REQUIRED); False -> escrow clipping.
    """
    grad_every = 1 if coord_mode == "sync" else merge_every
    specs = [
        StateSpec(
            "grads", "sum",
            (Op(OpKind.INCREMENT, "grads"),),
            (_inv("params_converge", InvariantKind.MATERIALIZED_VIEW, "params",
                  {"source": "grads"}),),
            merge_every=grad_every,
            note="gradient deltas: sum-merge (disjoint per-replica "
                 "contributions); view invariant 'params reflect all merged "
                 "grads' is confluent — deferral is a *semantics* knob "
                 "(staleness), not a correctness one"),
        StateSpec(
            "step", "max",
            (Op(OpKind.INCREMENT, "step"),),
            (_inv("step_monotone", InvariantKind.GREATER_THAN, "step",
                  {"threshold": -1}),),
            merge_every=0,
            note="monotone counter: max-join, never coordinates"),
        StateSpec(
            "metrics.loss_sum", "gcounter",
            (Op(OpKind.INCREMENT, "metrics.loss_sum"),),
            (_inv("metrics_reflect_steps", InvariantKind.MATERIALIZED_VIEW,
                  "metrics", {"source": "step"}),),
            merge_every=0,
            note="metrics are G-counters merged at log boundaries only"),
        StateSpec(
            "metrics.token_count", "gcounter",
            (Op(OpKind.INCREMENT, "metrics.token_count"),), (),
            merge_every=0),
        StateSpec(
            "data.cursor", "max",
            (Op(OpKind.ASSIGN_SOME, "data.cursor"),),
            (_inv("samples_unique", InvariantKind.UNIQUENESS, "data.cursor"),),
            merge_every=0,
            note="replica-namespaced shard cursors: disjoint ranges "
                 "(paper §5.1 'choose some value')"),
        StateSpec(
            "sample_ids", "or",
            (Op(OpKind.ASSIGN_SOME, "sample_ids"),),
            (_inv("sample_ids_unique", InvariantKind.UNIQUENESS, "sample_ids"),),
            merge_every=0),
        StateSpec(
            "loss_scale", "min",
            (Op(OpKind.DECREMENT, "loss_scale"), Op(OpKind.INCREMENT, "loss_scale")),
            (_inv("no_overflow_consensus", InvariantKind.LESS_THAN, "loss_scale",
                  {"threshold": "overflow"}),),
            merge_every=1,
            note="overflow consensus: increments toward the ceiling are not "
                 "confluent -> amortized via escrowed growth schedule"),
        StateSpec(
            "ckpt.manifest", "versioned",
            (Op(OpKind.INSERT, "ckpt.manifest"),),
            (_inv("manifest_complete", InvariantKind.MATERIALIZED_VIEW,
                  "ckpt.manifest", {"source": "params"}),),
            merge_every=0,
            note="checkpoint shard manifests merge as versioned slots"),
        StateSpec(
            "ckpt.sequence_id", "max",
            (Op(OpKind.INSERT, "ckpt.sequence_id"),),
            (_inv("ckpt_ids_sequential", InvariantKind.AUTO_INCREMENT,
                  "ckpt.sequence_id"),),
            merge_every=0,
            note="sequential checkpoint IDs: the TPC-C district counter "
                 "analog — deferred commit-time assignment by one assigner"),
    ]
    if exact_clip:
        specs.append(StateSpec(
            "grad_norm", "sum",
            (Op(OpKind.UPDATE, "grad_norm"),),
            (_inv("norm_is_global_l2", InvariantKind.CUSTOM, "grad_norm",
                  {"semantics": "exact global L2 across all replicas"}),),
            merge_every=1,
            note="exact global-norm clip: the invariant references global "
                 "state (no local rule applies) -> synchronous all-reduce "
                 "each step"))
    else:
        specs.append(StateSpec(
            "grad_norm", "sum",
            (Op(OpKind.INCREMENT, "grad_norm"),),
            (_inv("norm_below_share", InvariantKind.LESS_THAN, "grad_norm",
                  {"threshold": "clip/replicas", "escrow": True}),),
            merge_every=0,
            note="escrow clipping: each replica clips against its share "
                 "tau/sqrt(R) — hot path local (paper §8)"))
    return specs


def serving_state_specs() -> list[StateSpec]:
    """State specs for the serving runtime."""
    return [
        StateSpec("request_ids", "or",
                  (Op(OpKind.ASSIGN_SOME, "request_ids"),),
                  (_inv("request_ids_unique", InvariantKind.UNIQUENESS,
                        "request_ids"),),
                  merge_every=0,
                  note="replica-namespaced request IDs"),
        StateSpec("kv_cache", "lww",
                  (Op(OpKind.UPDATE, "kv_cache"),),
                  (_inv("kv_reflects_tokens", InvariantKind.MATERIALIZED_VIEW,
                        "kv_cache", {"source": "tokens"}),),
                  merge_every=0,
                  note="KV caches are per-sequence-private: no cross-replica "
                       "merge"),
        StateSpec("admission_budget", "escrow",
                  (Op(OpKind.DECREMENT, "admission_budget"),),
                  (_inv("budget_nonneg", InvariantKind.GREATER_THAN,
                        "admission_budget", {"threshold": 0}),),
                  merge_every=0,
                  note="token-budget admission control via escrow shares"),
        StateSpec("served_count", "gcounter",
                  (Op(OpKind.INCREMENT, "served_count"),), (),
                  merge_every=0),
        StateSpec("batch_slots", "versioned",
                  (Op(OpKind.INSERT, "batch_slots"),
                   Op(OpKind.CASCADING_DELETE, "batch_slots")),
                  (_inv("slot_refs_valid", InvariantKind.FOREIGN_KEY,
                        "batch_slots", {"references": "request_ids"}),),
                  merge_every=0,
                  note="continuous-batching slot table: "
                       "insert/cascading-free"),
    ]
