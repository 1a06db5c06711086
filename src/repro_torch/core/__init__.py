# The port's own copies of the analysis modules (invariants, txn, analyzer,
# planner: pure Python) and the lattice subset the TPC-C escrow path uses
# (lattice.py: hot_position, HotSetEscrow in PyTorch).
from .analyzer import Confluence, Strategy, Verdict, classify
from .invariants import Invariant, InvariantKind
from .lattice import HotSetEscrow, hot_position
from .planner import CoordClass, CoordinationPlan, PlanEntry, StateSpec, plan
from .txn import Op, OpKind, Transaction
