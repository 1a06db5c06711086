"""Concrete replicated systems — one per invariant class of Table 2.

Each factory returns a :class:`~repro_torch.core.witness.ReplicatedSystem`
whose states are small numpy structures, whose transaction pool draws the
paper's operations with random parameters, and whose merge is the appropriate
lattice join from core/lattice.py. These are the test vehicles for Theorem 1
(tests/test_torch_witness.py holds them to the reference's) and the material for the quickstart example.

The payroll application of paper §2 appears at the bottom, composed from the
same pieces.

The port's copy of ``repro.core.systems``, unchanged: the systems are
plain numpy in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from . import invariants as inv_mod
from . import txn as txn_mod
from .invariants import Invariant, InvariantKind
from .txn import Op, OpKind, Transaction
from .witness import ReplicatedSystem

# All example systems operate on plain numpy state for speed (thousands of
# tiny diamonds); the lattice algebra matches core/lattice.py semantics.

UNIVERSE = 32  # fixed ID universe for set-like states


# ---------------------------------------------------------------------------
# Uniqueness (primary key)
# ---------------------------------------------------------------------------


def _unique_check(state: dict) -> bool:
    ids = state["ids"][state["valid"]]
    return len(ids) == len(set(ids.tolist()))


def uniqueness_system(specific: bool, num_replicas: int = 3) -> ReplicatedSystem:
    """Insert users with IDs; unique-ID invariant.

    specific=True  -> "choose SPECIFIC value": IDs drawn from a tiny shared
                      range, so two replicas can pick the same one
                      (NOT confluent — the Stan/Mary anomaly).
    specific=False -> "choose SOME value": IDs are replica-namespaced
                      (id = seq * R + replica) — confluent.
    """
    state = {"ids": np.full(UNIVERSE, -1, np.int64),
             "valid": np.zeros(UNIVERSE, bool),
             "next_seq": np.zeros(num_replicas, np.int64)}

    def apply_insert(s, slot, replica, want_id):
        s = {k: v.copy() for k, v in s.items()}
        if specific:
            new_id = want_id
        else:
            new_id = int(s["next_seq"][replica]) * num_replicas + replica
            s["next_seq"][replica] += 1
        if not s["valid"][slot]:
            s["ids"][slot] = new_id
            s["valid"][slot] = True
        return s

    t = Transaction("insert_user",
                    (Op(OpKind.ASSIGN_SPECIFIC if specific else OpKind.ASSIGN_SOME,
                        "users.id"),),
                    apply=apply_insert)

    def pool(rng: np.random.Generator):
        return t, {"slot": int(rng.integers(0, UNIVERSE)),
                   "replica": int(rng.integers(0, num_replicas)),
                   "want_id": int(rng.integers(0, 4))}

    def merge(a, b):
        # commutative slot resolution: invalid slots rank as +inf, ties break
        # toward the smaller id (deterministic regardless of merge order)
        big = np.iinfo(np.int64).max
        ia = np.where(a["valid"], a["ids"], big)
        ib = np.where(b["valid"], b["ids"], big)
        valid = a["valid"] | b["valid"]
        ids = np.where(valid, np.minimum(ia, ib), -1)
        return {"ids": ids, "valid": valid,
                "next_seq": np.maximum(a["next_seq"], b["next_seq"])}

    return ReplicatedSystem(
        name=f"uniqueness[{'specific' if specific else 'some'}]",
        initial_state=state,
        txn_pool=pool,
        invariants=(Invariant("ids_unique", InvariantKind.UNIQUENESS,
                              "users.id", _unique_check),),
        merge=merge,
        bind_branch=lambda kw, b: {**kw, "replica": b} if "replica" in kw else kw)


# ---------------------------------------------------------------------------
# AUTO_INCREMENT (dense sequence, no gaps)
# ---------------------------------------------------------------------------


def auto_increment_system(num_replicas: int = 2) -> ReplicatedSystem:
    """Each replica appends the next sequential ID it believes is free."""

    state = {"ids": np.full(UNIVERSE, -1, np.int64),
             "valid": np.zeros(UNIVERSE, bool)}

    def check(s) -> bool:
        ids = sorted(s["ids"][s["valid"]].tolist())
        # dense & unique: 0..n-1
        return ids == list(range(len(ids)))

    def apply_insert(s, slot):
        s = {k: v.copy() for k, v in s.items()}
        next_id = int(s["valid"].sum())  # local belief of the next dense ID
        if not s["valid"][slot]:
            s["ids"][slot] = next_id
            s["valid"][slot] = True
        return s

    t = Transaction("insert_order", (Op(OpKind.INSERT, "orders.id"),),
                    apply=apply_insert)

    def pool(rng):
        return t, {"slot": int(rng.integers(0, UNIVERSE))}

    def merge(a, b):
        big = np.iinfo(np.int64).max
        ia = np.where(a["valid"], a["ids"], big)
        ib = np.where(b["valid"], b["ids"], big)
        valid = a["valid"] | b["valid"]
        return {"ids": np.where(valid, np.minimum(ia, ib), -1), "valid": valid}

    return ReplicatedSystem("auto_increment", state, pool,
                            (Invariant("dense_ids", InvariantKind.AUTO_INCREMENT,
                                       "orders.id", check),),
                            merge)


# ---------------------------------------------------------------------------
# Foreign keys: insert / naive delete / cascading delete
# ---------------------------------------------------------------------------


def foreign_key_system(deletes: bool = False, cascading: bool = False,
                       num_replicas: int = 3) -> ReplicatedSystem:
    """employees.dept references departments.id (the payroll example).

    State uses 2P-sets (add+tombstone masks). Naive delete tombstones only the
    department; cascading delete also tombstones referencing employees at
    *merge* time semantics (here: locally, and merge ORs the tombstones, which
    is what preserves confluence).
    """
    nd, ne = 8, UNIVERSE
    state = {
        "dept_added": np.zeros(nd, bool), "dept_removed": np.zeros(nd, bool),
        "emp_added": np.zeros(ne, bool), "emp_removed": np.zeros(ne, bool),
        "emp_dept": np.full(ne, -1, np.int64),
    }
    # seed some departments
    state["dept_added"][:4] = True

    def members(added, removed):
        return added & ~removed

    def check(s) -> bool:
        emp_live = members(s["emp_added"], s["emp_removed"])
        dept_live = members(s["dept_added"], s["dept_removed"])
        refs = s["emp_dept"][emp_live]
        return bool(np.all((refs >= 0) & dept_live[np.clip(refs, 0, nd - 1)]))

    def apply_hire(s, emp, dept):
        s = {k: v.copy() for k, v in s.items()}
        if members(s["dept_added"], s["dept_removed"])[dept] and not s["emp_added"][emp]:
            s["emp_added"][emp] = True
            s["emp_dept"][emp] = dept
        return s

    def apply_delete_dept(s, dept):
        s = {k: v.copy() for k, v in s.items()}
        s["dept_removed"][dept] = True
        if cascading:
            s["emp_removed"] |= (s["emp_dept"] == dept) & s["emp_added"]
        return s

    hire = Transaction("hire", (Op(OpKind.INSERT, "employees"),), apply=apply_hire)
    drop = Transaction("drop_dept",
                       (Op(OpKind.CASCADING_DELETE if cascading else OpKind.DELETE,
                           "departments"),),
                       apply=apply_delete_dept)

    def pool(rng):
        if deletes and rng.random() < 0.3:
            return drop, {"dept": int(rng.integers(0, 4))}
        return hire, {"emp": int(rng.integers(0, ne)),
                      "dept": int(rng.integers(0, 4))}

    def merge(a, b):
        out = {k: (a[k] | b[k]) for k in ("dept_added", "dept_removed",
                                          "emp_added", "emp_removed")}
        # commutative resolution of concurrent hires into the same slot
        big = np.iinfo(np.int64).max
        da = np.where(a["emp_added"], a["emp_dept"], big)
        db = np.where(b["emp_added"], b["emp_dept"], big)
        emp_dept = np.where(out["emp_added"], np.minimum(da, db), -1)
        out["emp_dept"] = emp_dept
        if cascading:
            # merge-time cascade: tombstones from either side remove dangling refs
            dept_removed = out["dept_removed"]
            dangling = out["emp_added"] & (emp_dept >= 0) & dept_removed[np.clip(emp_dept, 0, nd - 1)]
            out["emp_removed"] = out["emp_removed"] | dangling
        return out

    label = "cascade" if cascading else ("delete" if deletes else "insert")
    # In the paper's bag-union model concurrent inserts are *distinct*
    # records; the dense encoding realizes that by giving each replica its
    # own employee-slot range (insert identity is replica-namespaced).
    span = ne // max(num_replicas, 1)

    def bind(kw, b):
        if "emp" in kw:
            return {**kw, "emp": kw["emp"] % span + b * span}
        return kw

    return ReplicatedSystem(f"foreign_key[{label}]", state, pool,
                            (Invariant("emp_dept_fk", InvariantKind.FOREIGN_KEY,
                                       "employees.dept", check,
                                       {"references": "departments.id"}),),
                            merge,
                            bind_branch=bind)


# ---------------------------------------------------------------------------
# Threshold counters (ADTs, §5.2): balance >= 0 under increments/decrements
# ---------------------------------------------------------------------------


def counter_system(allow_decrement: bool, threshold: float = 0.0,
                   num_replicas: int = 3, initial: float = 100.0) -> ReplicatedSystem:
    """PN-counter bank balance with invariant value >= threshold."""

    state = {"pos": np.zeros(num_replicas), "neg": np.zeros(num_replicas),
             "base": np.array(initial)}

    def value(s):
        return float(s["base"] + s["pos"].sum() - s["neg"].sum())

    def check(s) -> bool:
        return value(s) >= threshold

    def apply_incr(s, replica, amount):
        s = {k: v.copy() for k, v in s.items()}
        s["pos"][replica] += amount
        return s

    def apply_decr(s, replica, amount):
        s = {k: v.copy() for k, v in s.items()}
        s["neg"][replica] += amount
        return s

    incr = Transaction("deposit", (Op(OpKind.INCREMENT, "accounts.balance"),),
                       apply=apply_incr)
    decr = Transaction("withdraw", (Op(OpKind.DECREMENT, "accounts.balance"),),
                       apply=apply_decr)

    def pool(rng):
        amount = float(rng.integers(1, 80))
        if allow_decrement and rng.random() < 0.6:
            return decr, {"replica": int(rng.integers(0, num_replicas)),
                          "amount": amount}
        return incr, {"replica": int(rng.integers(0, num_replicas)),
                      "amount": amount}

    def merge(a, b):
        return {"pos": np.maximum(a["pos"], b["pos"]),
                "neg": np.maximum(a["neg"], b["neg"]),
                "base": a["base"]}

    label = "incr+decr" if allow_decrement else "incr-only"
    return ReplicatedSystem(f"counter[{label}]", state, pool,
                            (inv_mod.greater_than("non_negative_balance",
                                                  "accounts.balance",
                                                  threshold - 1e-9, check),),
                            merge,
                            bind_branch=lambda kw, b: {**kw, "replica": b})


def escrow_counter_system(num_replicas: int = 3, initial: float = 120.0) -> ReplicatedSystem:
    """The §8 fix: decrements spend only a per-replica escrow share.

    Same invariant as counter_system(allow_decrement=True) — but confluent,
    because a replica refuses (aborts) any spend beyond its share.
    """
    share = initial / num_replicas
    state = {"spent": np.zeros(num_replicas), "base": np.array(initial),
             "share": np.array(share)}

    def check(s) -> bool:
        return float(s["base"] - s["spent"].sum()) >= 0.0 and \
            bool(np.all(s["spent"] <= s["share"] + 1e-9))

    def apply_spend(s, replica, amount):
        s = {k: v.copy() for k, v in s.items()}
        if s["spent"][replica] + amount <= s["share"]:
            s["spent"][replica] += amount
        return s

    spend = Transaction("withdraw_escrow",
                        (Op(OpKind.DECREMENT, "accounts.balance",
                            {"escrow": True}),),
                        apply=apply_spend)

    def pool(rng):
        return spend, {"replica": int(rng.integers(0, num_replicas)),
                       "amount": float(rng.integers(1, 80))}

    def merge(a, b):
        return {"spent": np.maximum(a["spent"], b["spent"]),
                "base": a["base"], "share": a["share"]}

    return ReplicatedSystem("counter[escrow]", state, pool,
                            (inv_mod.greater_than("non_negative_balance",
                                                  "accounts.balance", -1e-9,
                                                  check),),
                            merge,
                            bind_branch=lambda kw, b: {**kw, "replica": b})


# ---------------------------------------------------------------------------
# Materialized view / audit (Lamport's example, §2 & §4.3)
# ---------------------------------------------------------------------------


def audit_system(num_replicas: int = 3) -> ReplicatedSystem:
    """Deposits plus an audit that materializes the sum of balances.

    Not commutative at the level of states (audit result depends on order) but
    I-confluent w.r.t. 'audit total reflects only non-negative balances':
    the paper's argument that invariants, not state equivalence, are the right
    granularity.
    """
    state = {"pos": np.zeros((num_replicas, 4)),
             "audit": np.zeros(num_replicas),          # per-replica last audit
             "audit_version": np.zeros(num_replicas, np.int64)}

    def balances(s):
        return s["pos"].sum(axis=0)

    def check(s) -> bool:
        # audit snapshots must reflect only valid (non-negative) balances —
        # trivially true here (increment-only), the point is the diamond runs.
        return bool(np.all(balances(s) >= 0)) and bool(np.all(s["audit"] >= 0))

    def apply_deposit(s, replica, account, amount):
        s = {k: v.copy() for k, v in s.items()}
        s["pos"][replica, account] += amount
        return s

    def apply_audit(s, replica):
        s = {k: v.copy() for k, v in s.items()}
        s["audit"][replica] = balances(s).sum()
        s["audit_version"][replica] += 1
        return s

    deposit = Transaction("deposit", (Op(OpKind.INCREMENT, "accounts.balance"),),
                          apply=apply_deposit)
    audit = Transaction("audit", (Op(OpKind.READ, "accounts.balance"),
                                  Op(OpKind.MERGE_VIEW, "audit.total",
                                     {"source": "accounts.balance"})),
                        apply=apply_audit)

    def pool(rng):
        if rng.random() < 0.3:
            return audit, {"replica": int(rng.integers(0, num_replicas))}
        return deposit, {"replica": int(rng.integers(0, num_replicas)),
                         "account": int(rng.integers(0, 4)),
                         "amount": float(rng.integers(1, 50))}

    def merge(a, b):
        b_newer = b["audit_version"] > a["audit_version"]
        return {"pos": np.maximum(a["pos"], b["pos"]),
                "audit": np.where(b_newer, b["audit"], a["audit"]),
                "audit_version": np.maximum(a["audit_version"], b["audit_version"])}

    return ReplicatedSystem("audit", state, pool,
                            (Invariant("audit_nonneg", InvariantKind.MATERIALIZED_VIEW,
                                       "audit.total", check,
                                       {"source": "accounts.balance"}),),
                            merge,
                            bind_branch=lambda kw, b: {**kw, "replica": b})


# ---------------------------------------------------------------------------
# Set CONTAINS (confluent) and list HEAD=/length= (not confluent) — the last
# two rows of Table 2, as executable systems.
# ---------------------------------------------------------------------------


def contains_system(num_replicas: int = 3) -> ReplicatedSystem:
    """G-set inserts under a NOT-CONTAINS-forbidden-element invariant.

    Membership after union merge is the union of memberships; each replica
    locally refuses to insert the forbidden element, so no merge can
    introduce it (Table 2: [NOT] CONTAINS x Any -> confluent).
    """
    FORBIDDEN = 13
    state = {"members": np.zeros(UNIVERSE, bool)}

    def check(s) -> bool:
        return not bool(s["members"][FORBIDDEN])

    def apply_add(s, elem):
        s = {k: v.copy() for k, v in s.items()}
        if elem != FORBIDDEN:  # local check suffices
            s["members"][elem] = True
        return s

    add = Transaction("add_elem", (Op(OpKind.INSERT, "tags.set"),),
                      apply=apply_add)

    def pool(rng):
        return add, {"elem": int(rng.integers(0, UNIVERSE))}

    def merge(a, b):
        return {"members": a["members"] | b["members"]}

    return ReplicatedSystem("contains", state, pool,
                            (Invariant("no_forbidden", InvariantKind.CONTAINS,
                                       "tags.set", check,
                                       {"negated": True}),),
                            merge)


def list_position_system(num_replicas: int = 3) -> ReplicatedSystem:
    """Append-only list with a length-cap invariant (HEAD=/TAIL=/length=).

    Each replica can append while locally under the cap, but the merged list
    is the union of appends — cardinality is a global property, so two
    locally-valid appends can jointly cross the cap (Table 2: list mutation
    -> NOT confluent).
    """
    CAP = 6
    state = {"slots": np.zeros(UNIVERSE, bool),
             "next": np.zeros(num_replicas, np.int64)}

    def check(s) -> bool:
        return int(s["slots"].sum()) <= CAP

    def apply_append(s, replica):
        s = {k: v.copy() for k, v in s.items()}
        if s["slots"].sum() < CAP:  # locally valid append
            slot = int(s["next"][replica]) * num_replicas + replica
            if slot < UNIVERSE:
                s["slots"][slot] = True
                s["next"][replica] += 1
        return s

    t = Transaction("append", (Op(OpKind.LIST_MUTATE, "log.list"),),
                    apply=apply_append)

    def pool(rng):
        return t, {"replica": int(rng.integers(0, num_replicas))}

    def merge(a, b):
        return {"slots": a["slots"] | b["slots"],
                "next": np.maximum(a["next"], b["next"])}

    return ReplicatedSystem("list_position", state, pool,
                            (Invariant("length_cap", InvariantKind.LIST_POSITION,
                                       "log.list", check),),
                            merge,
                            bind_branch=lambda kw, b: {**kw, "replica": b})


# ---------------------------------------------------------------------------
# The payroll application (paper §2), assembled
# ---------------------------------------------------------------------------


def payroll_transactions() -> list[Transaction]:
    """Static descriptions of the payroll app's transactions for analysis."""
    return [
        txn_mod.txn("assign_employee_id",
                    txn_mod.assign_some("employees.id")),
        txn_mod.txn("assign_employee_id_manual",
                    txn_mod.assign_specific("employees.id")),
        # hire: the system generates the new employee's ID (some-value) and
        # inserts the department reference — both confluent (§2: adding Stan
        # and Mary to Engineering simultaneously is safe).
        txn_mod.txn("hire_into_department",
                    txn_mod.assign_some("employees.id"),
                    txn_mod.insert("employees.dept"),
                    txn_mod.read("departments")),
        txn_mod.txn("dissolve_department",
                    txn_mod.delete("departments", cascading=True)),
        txn_mod.txn("give_raise",
                    txn_mod.increment("employees.salary")),
        txn_mod.txn("cut_salary",
                    txn_mod.decrement("employees.salary")),
    ]


ALL_SYSTEM_FACTORIES = {
    "uniqueness_specific": lambda: uniqueness_system(specific=True),
    "uniqueness_some": lambda: uniqueness_system(specific=False),
    "auto_increment": auto_increment_system,
    "fk_insert": lambda: foreign_key_system(deletes=False),
    "fk_delete": lambda: foreign_key_system(deletes=True, cascading=False),
    "fk_cascade": lambda: foreign_key_system(deletes=True, cascading=True),
    "counter_incr": lambda: counter_system(allow_decrement=False),
    "counter_decr": lambda: counter_system(allow_decrement=True),
    "counter_escrow": escrow_counter_system,
    "audit": audit_system,
    "contains": contains_system,
    "list_position": list_position_system,
}

# Which systems the static analyzer says are confluent (expected dynamics).
EXPECTED_CONFLUENT = {
    "uniqueness_specific": False,
    "uniqueness_some": True,
    "auto_increment": False,
    "fk_insert": True,
    "fk_delete": False,
    "fk_cascade": True,
    "counter_incr": True,
    "counter_decr": False,
    "counter_escrow": True,
    "audit": True,
    "contains": True,
    "list_position": False,
}
