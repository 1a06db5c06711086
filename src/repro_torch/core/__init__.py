# The port of repro.core: invariant confluence analysis and coordination
# planning for replicated state.
#
#   lattice.py    — merge operators ⊔ (CRDT joins) over torch tensors; the
#                   VersionedSlots join is kernel B4 on the card
#   tree.py       — flatten/rebuild state trees in the reference's order
#   invariants.py — I : DB -> {true,false} predicate model (Table 2)
#   txn.py        — T : DB -> DB transaction/op model
#   analyzer.py   — static I-confluence classification (Table 2)
#   witness.py    — executable diamond diagrams (Theorem 1, both ways)
#   systems.py    — concrete replicated systems per invariant class
#   planner.py    — CoordinationPlan over runtime state trees
#   merge.py      — anti-entropy merges of state trees

from .analyzer import (Confluence, Strategy, Verdict, analyze_application,
                       analyze_transaction, classify, table2)
from .invariants import Invariant, InvariantKind
from .lattice import (EscrowCounter, GCounter, HotSetEscrow, LWWRegister,
                      PNCounter, TwoPhaseSet, VersionedSlots, get_bottom,
                      get_join, hot_position, tree_join_flat)
from .merge import converged, merge_many, merge_trees
from .planner import (CoordClass, CoordinationPlan, PlanEntry, StateSpec,
                      plan, plan_state, plan_states, serving_state_specs,
                      training_state_specs)
from .txn import Op, OpKind, Transaction, run_valid_sequence
from .witness import (DiamondResult, ReplicatedSystem,
                      check_confluence_empirically, check_convergence,
                      run_diamond, search_witness)

__all__ = [
    "Confluence", "Strategy", "Verdict", "analyze_application",
    "analyze_transaction", "classify", "table2",
    "Invariant", "InvariantKind",
    "EscrowCounter", "GCounter", "LWWRegister", "PNCounter", "TwoPhaseSet",
    "VersionedSlots", "get_bottom", "get_join", "tree_join_flat",
    "converged", "merge_many", "merge_trees",
    "CoordClass", "CoordinationPlan", "PlanEntry", "StateSpec", "plan_state",
    "plan_states", "serving_state_specs", "training_state_specs",
    "Op", "OpKind", "Transaction", "run_valid_sequence",
    "DiamondResult", "ReplicatedSystem", "check_confluence_empirically",
    "check_convergence", "run_diamond", "search_witness",
]
