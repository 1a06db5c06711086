"""Failure injection and recovery: the port of ``repro.runtime.failures``
(``PodSimulator`` for deferred training, ``EscrowPodSimulator`` for
escrow-regime TPC-C, and the analytic ``straggler_step_times``).

A training pod that fails stops stepping; the survivors keep stepping
(transactional availability: progress without the failed peer); the dead
pod restarts from a survivor's state and the next anti-entropy merge
reconciles — global I-validity (finite parameters, monotone step) holds
throughout. The pods are separate ``TrainState`` copies on one device,
driven through the same single-pod setup.

A TPC-C replica that fails stops serving; the others keep committing,
since their transactions never needed it; entries bound for it queue; its
escrow share reclaims to the survivors at the next refresh; on recovery
its queue drains through its retry ring and the twelve consistency
criteria hold on the reassembled state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.core.lattice import HotSetEscrow, pack_lease_stamp
from repro_torch.device import resolve_device
from repro_torch.txn import tpcc
from repro_torch.txn.tpcc import RetryState, TPCCState

from .liveness import LeaseMonitor


@dataclasses.dataclass
class PodSimulator:
    """Simulates N pod replicas on one device: each pod owns a TrainState
    and steps independently; merge averages parameters (the deferred
    merge)."""

    setup: object          # optim.coord.TrainSetup of one pod (sync mode)
    n_pods: int
    states: list = dataclasses.field(default_factory=list)
    alive: list = dataclasses.field(default_factory=list)
    metric_joined: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # default_factory (not a shared default, not an unconditional
        # overwrite): two simulators never alias the same list, and a
        # caller-provided fleet image survives construction
        if not self.states:
            self.states = [self.setup.init_fn(7) for _ in range(self.n_pods)]
        if not self.alive:
            self.alive = [True] * self.n_pods
        # host-side G-counter view of the fleet's metrics: slot i is pod
        # i's contribution as of its last merge (slotwise max-join — each
        # pod only ever grows its own slot)
        if not self.metric_joined:
            self.metric_joined = {
                "loss": np.zeros(self.n_pods),
                "tokens": np.zeros(self.n_pods),
                "grad_norm": np.zeros(self.n_pods),
            }

    def step(self, batches: list) -> None:
        for i in range(self.n_pods):
            if self.alive[i]:
                self.states[i] = self.setup.step_fn(self.states[i], batches[i])

    def kill(self, pod: int) -> None:
        self.alive[pod] = False

    def recover(self, pod: int, from_state=None) -> None:
        """Restart from a checkpointed/survivor state (elastic restore).

        The recovered pod must NOT inherit the source state's metric slots
        (that would double-count the survivor's contribution at the next
        join); it resumes its OWN counter from the last joined value, so
        nothing merged before the kill is lost and nothing is counted
        twice."""
        self.alive[pod] = True
        src = from_state if from_state is not None else self._survivor_state()
        state = T.map(torch.clone, src)
        state = state._replace(
            loss_slots=torch.full_like(
                state.loss_slots, self.metric_joined["loss"][pod]),
            token_slots=torch.full_like(
                state.token_slots, self.metric_joined["tokens"][pod]),
            grad_norm_slots=torch.full_like(
                state.grad_norm_slots, self.metric_joined["grad_norm"][pod]))
        self.states[pod] = state

    def _survivor_state(self):
        for i, a in enumerate(self.alive):
            if a:
                return self.states[i]
        raise RuntimeError("no survivors")

    def _join_metrics(self) -> None:
        """Slotwise max-join of every live pod's metric contribution into
        the fleet G-counter view (idempotent: slots only grow)."""
        for i, a in enumerate(self.alive):
            if not a:
                continue
            s = self.states[i]
            self.metric_joined["loss"][i] = max(
                self.metric_joined["loss"][i], float(s.loss_slots.sum()))
            self.metric_joined["tokens"][i] = max(
                self.metric_joined["tokens"][i], float(s.token_slots.sum()))
            self.metric_joined["grad_norm"][i] = max(
                self.metric_joined["grad_norm"][i],
                float(s.grad_norm_slots.max()))

    def fleet_metrics(self) -> dict:
        """G-counter read over the fleet: join live pods' current slots in,
        then sum contributions (dead pods keep their last-merged slot)."""
        self._join_metrics()
        return {
            "loss_sum": float(self.metric_joined["loss"].sum()),
            "tokens": float(self.metric_joined["tokens"].sum()),
            "grad_norm_max": float(self.metric_joined["grad_norm"].max()),
        }

    def merge(self) -> None:
        """Anti-entropy among live pods: parameter mean, step max-join,
        metric G-counter joins (slotwise max of per-pod contributions)."""
        self._join_metrics()
        live = [self.states[i] for i, a in enumerate(self.alive) if a]
        if len(live) < 2:
            return
        n = len(live)
        mean_params = T.map(
            lambda *xs: sum(x.to(torch.float32) for x in xs) / n,
            *[s.params for s in live])
        step = torch.max(torch.stack([s.step for s in live]))
        # each pod gets its OWN copy: replicas never alias storage
        merged = [s._replace(
            params=T.map(lambda m, p: m.to(p.dtype).clone(), mean_params,
                        s.params),
            step=step.clone()) for s in live]
        j = 0
        for i, a in enumerate(self.alive):
            if a:
                self.states[i] = merged[j]
                j += 1

    def check_validity(self) -> bool:
        """Global I-validity: finite parameters on every live replica."""
        for i, a in enumerate(self.alive):
            if not a:
                continue
            for leaf in T.leaves(self.states[i].params):
                if not bool(torch.isfinite(leaf).all()):
                    return False
        return True

    def divergence(self) -> float:
        """Max parameter distance between live replicas (0 after merge)."""
        live = [self.states[i] for i, a in enumerate(self.alive) if a]
        if len(live) < 2:
            return 0.0
        worst = 0.0
        base = T.leaves(live[0].params)
        for other in live[1:]:
            for a, b in zip(base, T.leaves(other.params)):
                worst = max(worst, float(
                    (a.to(torch.float32) - b.to(torch.float32)).abs().max()))
        return worst


@dataclasses.dataclass
class EscrowPodSimulator:
    """Simulates R escrow-regime TPC-C replicas on one device, with kills.

    Each replica owns a contiguous warehouse range (its own copy of those
    rows of every table) plus one row of the hot-set escrow shares and one
    owner-local cold-retry ring. Remote order-lines route host-side through
    per-owner pending queues (the outbox in flight). Killing a replica
    freezes its slice, queue and ring — exactly a crashed shard whose
    durable image stops moving; survivors keep admitting:

    * entries destined to the dead owner stay QUEUED (nothing silently
      drops);
    * at refresh boundaries the dead replica's escrow row reclaims to the
      survivors (``HotSetEscrow.make(..., alive=...)``);
    * refresh budgets subtract hot demand still queued at dead owners —
      those lines were share-admitted upstream and WILL apply on recovery,
      so their stock is already spoken for.

    ``checkpoint``/``recover`` round-trip the full run image through
    ``txn.recovery`` (manifest lattice + atomic commit); a recovered
    replica resumes from the checkpointed slice — bit-identical to its
    frozen image, since only the owner writes its slice.

    **Self-detecting mode** (``liveness=True``): ``kill``/``stall`` flip
    only the replica's OWN process state, and the fleet finds out through
    the heartbeat/lease lattice (``runtime.liveness.LeaseMonitor``): every
    drain window each serving replica beats, the monitor derives the alive
    mask with hysteresis, and on detection ``owner_of`` re-keys the dead
    shard to its ring-order successor among the alive replicas, which
    mounts the shard's durable image and keeps draining its cold traffic.
    ``revive`` hands the shard back (an epoch bump keeps stamps monotone);
    a falsely suspected replica self-fences but keeps beating, so it is
    re-admitted automatically.

    **Reservations** (``reserve=True``): a cold ring entry on its LAST
    permitted retry converts to an owner-granted reservation instead of a
    final reject; the cold ledger extends with ``res_granted ==
    res_completed + reserved_in_ring`` and stays exact.

    The numpy stream is the reference's draw for draw (one
    ``generate_neworder`` a serving replica a step) and each drain pads to
    the same power of two, so the counts are the reference's. One declared
    difference: ``step`` admits with ``admission="kernel"``,
    ``effects="fused"`` (the megastep kernel on the card, its plain version
    on the CPU), where the reference uses the per-phase scan; the admission
    contract makes the two bit-identical. ``device=None`` means the CUDA card.
    """

    scale: object               # tpcc.TPCCScale
    n_replicas: int
    retry_cap: int = 32
    retry_max: int = 3
    hot_items: int | None = None
    seed: int = 0
    stock_scale: int = 1        # plump inventory (decouple from exhaustion)
    reserve: bool = False       # last-retry owner-granted reservations
    liveness: bool = False      # self-detecting lease mode (no caller mask)
    lease_expiry: int = 1       # windows without a beat before SUSPECT
    lease_hysteresis: int = 1   # suspect windows absorbed before DEAD
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        R, W = self.n_replicas, self.scale.n_warehouses
        assert W % R == 0, "warehouses must split evenly across replicas"
        self.wp = W // R
        self.rng = np.random.default_rng(self.seed)
        full = tpcc.init_state(self.scale, seed=self.seed,
                               device=self.device)
        if self.stock_scale != 1:
            full.s_quantity.mul_(self.stock_scale)
        self.initial_stock = full.s_quantity.cpu().numpy().copy()
        # contiguous row blocks, cloned: a killed replica's image freezes
        self.slices = [TPCCState(*(x[r * self.wp:(r + 1) * self.wp].clone()
                                   for x in full)) for r in range(R)]
        del full
        hot = (self.hot_items if self.hot_items is not None
               else tpcc.default_hot_items(self.scale))
        self.hot_keys_np = tpcc.select_hot_cells(self.scale, hot)
        self.hot_keys = torch.from_numpy(self.hot_keys_np).to(self.device)
        self._hot_set = set(int(k) for k in self.hot_keys_np)
        self.esc = HotSetEscrow.make(R, self.hot_keys, self._hot_budgets())
        self.rings = [tpcc.empty_retry(self.retry_cap, self.device)
                      for _ in range(R)]
        self.pending = [[] for _ in range(R)]   # owner -> [(dst_w,i,qty)]
        self.alive = [True] * R     # the fleet's VIEW (liveness: derived)
        self.ts0 = [0] * R
        # replica process truth (what the lease lattice must discover):
        self.up = [True] * R        # kill() flips this, never alive[]
        self.stalled = [0] * R      # windows this replica will miss
        self.hb_seq = [0] * R       # heartbeat sequence (beats each window)
        self.epoch = [0] * R        # bumped on revive/recover (monotone)
        self.owner_of = list(range(R))   # shard -> serving replica
        self.monitor = None
        if self.liveness:
            self.monitor = LeaseMonitor(R, expiry=self.lease_expiry,
                                        hysteresis=self.lease_hysteresis)
        # exact cold-tier ledger: sent == applied + final + queued + in-ring
        self.cold_sent = 0
        self.cold_applied = 0
        self.final_rejects = 0
        self.committed = 0          # New-Orders admitted fleet-wide
        self.res_granted = 0        # reservations granted (stock debited)
        self.res_completed = 0      # reservations completed (left the ring)

    # -- internal helpers ----------------------------------------------------

    def _hot_budgets(self) -> np.ndarray:
        """Refresh budgets: current hot stock minus hot demand still queued
        at (dead) owners — queued hot lines are share-admitted upstream and
        apply unconditionally later, so that stock is already committed."""
        stock = torch.cat([s.s_quantity for s in self.slices]).reshape(-1)
        budgets = stock[self.hot_keys.long()].cpu().numpy()
        key_pos = {int(k): i for i, k in enumerate(self.hot_keys_np)}
        for q in getattr(self, "pending", []):
            for (w, i, qty) in q:
                pos = key_pos.get(w * self.scale.n_items + i)
                if pos is not None:
                    budgets[pos] -= qty
        return np.maximum(budgets, 0)

    def _is_cold(self, w: int, i: int) -> bool:
        return (w * self.scale.n_items + i) not in self._hot_set

    # -- replica lifecycle ---------------------------------------------------

    def kill(self, replica: int) -> None:
        """Crash one replica's process. In liveness mode this touches ONLY
        the replica's own ``up`` bit — the fleet's ``alive`` view changes
        when the lease monitor detects the missing beats; otherwise the
        view flips at once (the omniscient caller)."""
        self.up[replica] = False
        if not self.liveness:
            self.alive[replica] = False

    def stall(self, replica: int, windows: int) -> None:
        """Straggler injection: the replica misses ``windows`` drain windows
        (no serving, no beats) but is NOT dead — whether the fleet falsely
        suspects it depends on the lease hysteresis."""
        self.stalled[replica] = windows

    def revive(self, replica: int) -> None:
        """Rejoin: remount the shard's CURRENT durable image (a successor
        may have applied work to it — restoring a checkpoint here would
        lose that) and resume beating under a bumped epoch so the revived
        stamps stay strictly above everything the old incarnation wrote."""
        self.up[replica] = True
        self.stalled[replica] = 0
        self.epoch[replica] += 1
        self.hb_seq[replica] = 0
        if not self.liveness:
            self.alive[replica] = True

    def _serving(self, replica: int) -> bool:
        """A replica serves iff its process is healthy AND its own lease
        view says it is alive (self-fencing: once the fleet could have
        re-keyed its shard to a successor, a falsely-suspected replica must
        not also write — the split-brain guard)."""
        return (self.up[replica] and self.stalled[replica] == 0
                and self.alive[replica])

    def _tick_liveness(self) -> None:
        """One lease window: healthy replicas beat, stalls age one window,
        the monitor joins the fleet's stamps (riding the drain exchange —
        no extra collective) and re-derives the alive mask, and shard
        ownership re-keys to ring-order successors."""
        R = self.n_replicas
        for r in range(R):
            if self.up[r] and self.stalled[r] == 0:
                self.hb_seq[r] += 1
            if self.stalled[r] > 0:
                self.stalled[r] -= 1
        stamps = np.asarray([int(pack_lease_stamp(self.epoch[r],
                                                  self.hb_seq[r]))
                             for r in range(R)], np.int64)
        self.monitor.observe(stamps)
        self.alive = [bool(a) for a in self.monitor.tick()]
        self._rekey_owners()

    def _rekey_owners(self) -> None:
        """Deterministic successor election, no negotiation: every observer
        with the same lease view computes the same map — an alive shard
        owner keeps (or takes back) its shard; a dead owner's shard goes to
        the next alive replica in ring order; with nobody alive the shard
        freezes in place."""
        R = self.n_replicas
        for s in range(R):
            if self.alive[s]:
                self.owner_of[s] = s
                continue
            for k in range(1, R):
                cand = (s + k) % R
                if self.alive[cand]:
                    self.owner_of[s] = cand
                    break

    def checkpoint(self, directory: str, step: int):
        """Full run image (reassembled state + escrow + stacked rings)
        through the crash-safe manifest-lattice commit."""
        from repro_torch.txn import recovery
        rings = RetryState(*(torch.stack(xs) for xs in zip(*self.rings)))
        return recovery.save_run(directory, self.full_state(), step,
                                 esc=self.esc, retry=rings)

    def recover(self, replica: int, directory: str) -> None:
        """Restart a killed replica from the newest committed manifest:
        take ITS warehouse slice and ring row (only the owner ever writes
        them, so the checkpointed image is its exact frozen state)."""
        from repro_torch.txn import recovery
        rr = recovery.restore_run(directory)
        if rr is None:
            raise FileNotFoundError(f"no recoverable checkpoint in "
                                    f"{directory}")
        lo = replica * self.wp
        self.slices[replica] = TPCCState(*(
            x[lo:lo + self.wp].to(self.device, copy=True)
            for x in rr.state))
        if rr.retry is not None:
            self.rings[replica] = RetryState(*(
                x[replica].to(self.device, copy=True) for x in rr.retry))
        self.up[replica] = True
        self.stalled[replica] = 0
        self.epoch[replica] += 1
        self.hb_seq[replica] = 0
        if not self.liveness:
            self.alive[replica] = True

    # -- the run -------------------------------------------------------------

    def step(self, batch_size: int, remote_frac: float = 0.3,
             item_skew: float = 1.2) -> None:
        """One New-Order batch on every SERVING replica; remote lines route
        to the owners' pending queues (messages in flight). A killed or
        stalled replica's frontend is silent; a self-fenced (falsely
        suspected) replica admits nothing until re-admitted."""
        for r in range(self.n_replicas):
            if not self._serving(r):
                continue
            batch = tpcc.generate_neworder(
                self.rng, self.scale, batch_size, remote_frac=remote_frac,
                w_lo=r * self.wp, w_hi=(r + 1) * self.wp,
                ts0=self.ts0[r], item_skew=item_skew, device=self.device)
            self.ts0[r] += batch_size
            st, spent_row, delta, _, committed = \
                tpcc.apply_neworder_escrow_sparse(
                    self.slices[r], self.hot_keys, self.esc.shares[r],
                    self.esc.spent[r], batch, self.scale,
                    w_lo=r * self.wp, w_hi=(r + 1) * self.wp, replica=r,
                    num_replicas=self.n_replicas, admission="kernel",
                    effects="fused")
            self.slices[r] = st
            self.esc.spent[r].copy_(spent_row)
            self.committed += int(committed.sum())
            valid = delta.valid.cpu().numpy()
            for w, i, q in zip(delta.dst_w.cpu().numpy()[valid],
                               delta.i_id.cpu().numpy()[valid],
                               delta.qty.cpu().numpy()[valid]):
                owner = int(w) // self.wp
                self.pending[owner].append((int(w), int(i), int(q)))
                if self._is_cold(int(w), int(i)):
                    self.cold_sent += 1

    def drain(self) -> None:
        """Each shard's queued entries apply through its retry ring when its
        SERVING replica (``owner_of`` — the owner itself, or its adopted
        successor once the monitor re-keyed) is up; otherwise the shard's
        queue and ring freeze in place. With ``reserve`` on, last-retry
        entries convert to reservations (granted now, completed next
        window). In liveness mode the window closes with one lease tick:
        beats join, the alive view re-derives, ownership re-keys."""
        for s in range(self.n_replicas):
            server = self.owner_of[s]
            if not (self.up[server] and self.stalled[server] == 0
                    and self.alive[server]):
                continue
            q = self.pending[s]
            width = 8
            while width < max(len(q), 1):
                width *= 2                  # pad: the reference's shapes
            cols = np.zeros((3, width), np.int32)
            mask = np.zeros(width, bool)
            for j, entry in enumerate(q):
                cols[:, j], mask[j] = entry, True
            dst, iid, qty = (torch.from_numpy(c).to(self.device)
                             for c in cols)
            new_cold = sum(1 for (w, i, _) in q if self._is_cold(w, i))
            ring = self.rings[s]
            ring_before = int(ring.valid.sum())
            res_before = int((ring.valid & ring.reserved).sum())
            st, ring, final = tpcc.apply_stock_updates_strict_tiered_retry(
                self.slices[s], self.hot_keys, dst, iid, qty,
                torch.from_numpy(mask).to(self.device),
                torch.ones(width, dtype=torch.bool, device=self.device),
                ring, self.scale.n_items, w_lo=s * self.wp,
                retry_max=self.retry_max, reserve=1 if self.reserve else 0)
            self.slices[s], self.rings[s] = st, ring
            self.pending[s] = []
            final = int(final)
            ring_after = int(ring.valid.sum())
            res_after = int((ring.valid & ring.reserved).sum())
            self.final_rejects += final
            # reserved entries count APPLIED at completion, which is
            # exactly when they leave the ring
            self.cold_applied += (ring_before + new_cold
                                  - ring_after - final)
            if self.reserve:
                self.res_completed += res_before   # pass 0 completed these
                self.res_granted += res_after      # pass 3 granted these
        if self.liveness:
            self._tick_liveness()

    def quiesce(self, rounds: int | None = None) -> None:
        """Drain until every in-flight and in-ring entry has resolved —
        ``retry_max`` windows to exhaust retries plus one for a last-window
        reservation to complete, with one window of slack."""
        for _ in range(rounds if rounds is not None
                       else self.retry_max + 3):
            self.drain()

    def refresh(self) -> None:
        """Liveness-aware share refresh: dead rows reclaim to survivors,
        budgets already net of in-flight hot demand."""
        self.esc = HotSetEscrow.make(
            self.n_replicas, self.hot_keys, self._hot_budgets(),
            alive=np.asarray(self.alive, np.int32))

    # -- verification --------------------------------------------------------

    def full_state(self) -> TPCCState:
        return TPCCState(*(torch.cat(xs) for xs in zip(*self.slices)))

    def cold_ledger(self) -> dict:
        """Exact cold-tier accounting — nothing silently drops: every
        optimistically admitted remote-cold line is applied, finally
        rejected, queued at a (dead) owner, or riding a retry ring."""
        queued = sum(sum(1 for (w, i, _) in q if self._is_cold(w, i))
                     for q in self.pending)
        in_ring = sum(int(ring.valid.sum()) for ring in self.rings)
        reserved_in_ring = sum(int((ring.valid & ring.reserved).sum())
                               for ring in self.rings)
        return {"sent": self.cold_sent, "applied": self.cold_applied,
                "final_rejects": self.final_rejects, "queued": queued,
                "in_ring": in_ring,
                "reserved_in_ring": reserved_in_ring,
                "res_granted": self.res_granted,
                "res_completed": self.res_completed,
                "exact": (self.cold_sent == self.cold_applied
                          + self.final_rejects + queued + in_ring),
                "reservations_exact": (self.res_granted
                                       == self.res_completed
                                       + reserved_in_ring)}

    def audit(self):
        from repro_torch.txn.audit import assert_audit
        return assert_audit(self.full_state(), escrow=self.esc,
                            initial_stock=self.initial_stock,
                            strict_stock=True)


def straggler_step_times(n_pods: int, merge_every: int, steps: int,
                         straggler_pod: int = 0, slowdown: float = 3.0,
                         base_ms: float = 100.0, seed: int = 0,
                         mode: str = "transient",
                         hiccup_prob: float = 0.1) -> dict:
    """Analytic straggler model: with per-step synchronization every step
    costs the max over pods; with deferred merge only merge boundaries do.

    mode="transient" (default): each step each pod independently suffers a
    ``slowdown``x stall with probability ``hiccup_prob`` (network hiccups,
    preemptions, GC) — sync pays EVERY hiccup anywhere in the fleet, while
    deferred merge absorbs them inside the window. mode="permanent": one
    pod is always slow — no execution strategy can help; deferred merely
    removes the barrier overhead.
    """
    rng = np.random.default_rng(seed)
    times = rng.normal(base_ms, base_ms * 0.05, size=(steps, n_pods)).clip(1)
    if mode == "permanent":
        times[:, straggler_pod] *= slowdown
    else:
        hiccup = rng.random((steps, n_pods)) < hiccup_prob
        times = np.where(hiccup, times * slowdown, times)

    sync_makespan = times.max(axis=1).sum()

    deferred = 0.0
    acc = np.zeros(n_pods)
    for t in range(steps):
        acc += times[t]
        if (t + 1) % merge_every == 0:
            deferred += acc.max()   # barrier only at merge
            acc[:] = 0.0
    deferred += acc.max()
    return {"sync_ms": float(sync_makespan),
            "deferred_ms": float(deferred),
            "speedup": float(sync_makespan / deferred)}
