"""TPC-C serving end to end, on the CUDA card unless ``--device cpu``: the
port of the reference's ``examples/tpcc_serve.py``, with its sections and
flags.

It runs New-Order, Payment and Delivery against the coordination-avoiding
engine with batched request streams, proves the hot path (and a chunk of
the fused executor) coordination-free, compares the fused executor with
the per-batch dispatch path and with the 2PC baseline, audits the twelve
consistency criteria, prints the observability plane's dashboard (metrics
lattice, phase spans, coordination ledger), and shows the planner picking
three regimes (merge / escrow / 2PC) for three declared stock invariants,
the strict escrow regime audited for conservation against strict 2PC.

    PYTHONPATH=src python -m repro_torch.launch.tpcc_serve [--batches 40]

``--chaos`` runs the self-detecting liveness demo instead: four escrow
replicas with heartbeat leases (no caller passes an alive mask) take a
kill mid-run, detect it within the lease bound, re-key the dead shard to
its ring successor, serve degraded, and hand the shard back on revival;
it prints the degraded throughput, the detection latency and the
reservation-extended cold ledger. ``--json PATH`` writes the observability
snapshot (schema ``"repro.obs/1"``, the reference's).
"""

from __future__ import annotations

import argparse
import time


def chaos_demo(args) -> None:
    """Kill -> self-detect -> re-key -> degraded serve -> revive ->
    handback, with nobody passing an alive mask at any point."""
    from repro_torch.obs import ObsSession
    from repro_torch.runtime.failures import EscrowPodSimulator
    from repro_torch.txn.audit import check_cold_ledger
    from repro_torch.txn.tpcc import TPCCScale

    scale = TPCCScale(n_warehouses=4, districts=2, customers=16,
                      n_items=64, order_capacity=1024, max_lines=15)
    windows, batch = max(args.batches // 3, 9), 16
    sim = EscrowPodSimulator(scale, n_replicas=4, retry_cap=128,
                             retry_max=3, seed=11, stock_scale=3,
                             liveness=True, reserve=True, device=args.device)
    print(f"chaos: 4 replicas, self-detecting leases (expiry="
          f"{sim.monitor.expiry}, hysteresis={sim.monitor.hysteresis}, "
          f"detection bound {sim.monitor.detection_bound} windows), "
          f"last-retry reservations on")

    kill_at, revive_at = windows // 3, 2 * windows // 3
    detected_in, t0 = None, time.perf_counter()
    for t in range(windows):
        if t == kill_at:
            sim.kill(2)
            print(f"  window {t}: replica 2 killed (no mask handed to "
                  f"anyone — the lease monitor must notice)")
        if t == revive_at:
            sim.revive(2)
            print(f"  window {t}: replica 2 revived (remounts the "
                  f"successor-maintained slice)")
        sim.step(batch, remote_frac=0.5, item_skew=1.2)
        sim.drain()
        sim.refresh()
        if detected_in is None and not sim.alive[2] and t >= kill_at:
            detected_in = t - kill_at + 1
            print(f"  window {t}: monitor declared replica 2 dead "
                  f"(detection latency {detected_in} windows, bound "
                  f"{sim.monitor.detection_bound}); shard 2 re-keyed to "
                  f"replica {sim.owner_of[2]}")
    wall = time.perf_counter() - t0
    sim.quiesce()
    sim.refresh()

    led = sim.cold_ledger()
    check_cold_ledger(led, quiescent=True)
    rep = sim.audit()
    outage = revive_at - kill_at
    print(f"degraded-mode throughput: {sim.committed} committed txns over "
          f"{windows} windows ({sim.committed / max(wall, 1e-9):,.0f} "
          f"txn/s; {outage} of them with 3/4 replicas serving)")
    print(f"handback: shard 2 owner is replica {sim.owner_of[2]}, "
          f"alive={sim.alive[2]}")
    print(f"reservations: {led['res_granted']} granted, "
          f"{led['res_completed']} completed "
          f"(extended ledger exact: {led['reservations_exact']})")
    print("audit:", rep.describe())

    obs = ObsSession(metrics=False, trace=False)
    obs.record_heartbeat_lags(sim.monitor.detection_lags())
    print("detection latency (windows):", obs.detection_latency_summary())
    if args.json:
        with open(args.json, "w") as f:
            f.write(obs.to_json())
        print(f"wrote chaos observability snapshot -> {args.json}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--batch-per-shard", type=int, default=64)
    ap.add_argument("--warehouses", type=int, default=8)
    ap.add_argument("--remote-frac", type=float, default=0.01)
    ap.add_argument("--chaos", action="store_true",
                    help="run the self-detecting liveness demo instead: "
                         "kill a replica mid-run, let the lease monitor "
                         "detect it, serve degraded via the ring "
                         "successor, revive, and print degraded-mode "
                         "throughput + detection latency")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write the full observability snapshot (metrics "
                         "lattice + phase spans + coordination ledger) to "
                         "PATH after the instrumented full-mix run")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device present; pass --device cpu")
    if args.chaos:
        chaos_demo(args)
        return 0

    from repro_torch.core.planner import plan
    from repro_torch.obs import ObsSession
    from repro_torch.txn.audit import assert_audit
    from repro_torch.txn.drivers import (run_closed_loop, run_escrow_loop,
                                         run_mixed_loop)
    from repro_torch.txn.engine import plan_engine, single_host_engine
    from repro_torch.txn.executor import get_fused_executor
    from repro_torch.txn.latency import DelayModel, simulate
    from repro_torch.txn.tpcc import (TPCCScale, check_consistency,
                                      init_state, tpcc_state_specs)
    from repro_torch.txn.twopc import TwoPCEngine, run_closed_loop_2pc

    dev = args.device
    scale = TPCCScale(n_warehouses=args.warehouses, districts=10,
                      customers=64, n_items=512, order_capacity=4096)
    engine = single_host_engine(scale, device=dev)
    fresh = lambda: engine.shard_state(init_state(scale, device=dev))  # noqa: E731
    print(f"engine: {scale.n_warehouses} warehouses on "
          f"{engine.n_shards} shard(s), {dev}")

    print("\n-- structural proof (paper Definition 5) --")
    print("hot path:", engine.prove_coordination_free(8))
    print("fused megastep (8 full-mix iterations/replay):",
          get_fused_executor(engine).prove_megastep_coordination_free())
    ae = engine.count_anti_entropy_collectives(8)
    print("anti-entropy (async):", ae.describe())

    print("\n-- the coordination plan (core/planner over the TPC-C schema) --")
    print(engine.plan.summary())

    print("\n-- full mix: New-Order + Payment + Delivery (criteria audit) --")
    state, _ = run_closed_loop(
        engine, fresh(), batch_per_shard=args.batch_per_shard,
        n_batches=max(args.batches // 2, 4), remote_frac=args.remote_frac,
        merge_every=8, payments=True, deliveries=True)
    criteria = check_consistency(state)
    ok = sum(criteria.values())
    print(f"consistency criteria: {ok}/12 hold "
          f"{'✓' if ok == 12 else '✗ ' + str(criteria)}")
    print("independent audit:", assert_audit(state).describe())

    print("\n-- New-Order throughput (fused executor vs per-batch dispatch) --")
    state, stats = run_closed_loop(
        engine, fresh(), batch_per_shard=args.batch_per_shard,
        n_batches=args.batches, remote_frac=args.remote_frac, merge_every=8)
    print(f"fused:    committed {stats.committed} New-Order txns in "
          f"{stats.wall_seconds:.2f}s -> {stats.throughput:,.0f} txn/s "
          f"({dev}, {engine.n_shards} shard(s))")
    sd, dstats = run_closed_loop(
        engine, fresh(), batch_per_shard=args.batch_per_shard,
        n_batches=args.batches, remote_frac=args.remote_frac, merge_every=8,
        fused=False)
    print(f"dispatch: {dstats.throughput:,.0f} txn/s -> fused executor is "
          f"{stats.throughput / max(dstats.throughput, 1e-9):.1f}x")

    print("\n-- observability plane (metrics lattice + tracer + ledger) --")
    obs = ObsSession(metrics=True, trace=True, ledger=True)
    so, ostats = run_mixed_loop(
        engine, fresh(), batch_per_shard=args.batch_per_shard,
        n_batches=args.batches, remote_frac=args.remote_frac, merge_every=8,
        obs=obs)
    print(f"instrumented full mix: {ostats.throughput:,.0f} txn/s "
          f"(the metrics-on chunk is the metrics-off graph)")
    print(obs.dashboard())
    if args.json:
        with open(args.json, "w") as f:
            f.write(obs.to_json())
        print(f"wrote observability snapshot -> {args.json}")

    print("\n-- coordinated (2PC-style) baseline --")
    two = TwoPCEngine(scale, device=dev)
    # charge the LAN atomic-commitment latency the paper measures (Fig. 3)
    lan = simulate("D-2PC", DelayModel("lan"), n_servers=2, trials=500)
    per_batch = lan.mean_latency_ms / 1e3
    s2, stats2 = run_closed_loop_2pc(
        two, fresh(), batch_per_shard=args.batch_per_shard,
        n_batches=args.batches, remote_frac=args.remote_frac,
        commit_latency_s=per_batch)
    print(f"2PC baseline: {stats2.throughput:,.0f} txn/s "
          f"(incl. {lan.mean_latency_ms:.2f} ms commitment/round)")
    print("2PC hot path:", two.hot_path_collectives(8).describe())
    print(f"\ncoordination-avoiding speedup: "
          f"{stats.throughput / max(stats2.throughput, 1e-9):.2f}x")

    print("\n-- three regimes, one invariant knob (plan-selected) --")
    for mode in ("restock", "strict", "serial"):
        entry = plan(tpcc_state_specs(mode)).entry("stock.s_quantity")
        print(f"  stock_invariant={mode:8s} -> {entry.coord_class.value} "
              f"[{entry.strategy.value}]")

    print("\n-- escrow regime: strict s_quantity >= 0 without hot-path "
          "coordination --")
    es = single_host_engine(scale, stock_invariant="strict", device=dev)
    print("escrow hot path:", es.prove_coordination_free(8))
    print("share refresh (the only collective):",
          es.count_refresh_collectives().describe())

    def plump():
        s = es.shard_state(init_state(scale, device=dev))
        s.s_quantity.mul_(20)
        return s

    s3 = plump()
    q0 = s3.s_quantity.clone()
    s3, esc, st3 = run_escrow_loop(
        es, s3, batch_per_shard=args.batch_per_shard,
        n_batches=args.batches, remote_frac=args.remote_frac,
        merge_every=8, refresh_every=2, mix=False, fused=True)
    print(f"escrow:     {st3.neworders / st3.wall_seconds:,.0f} committed "
          f"txn/s ({st3.aborts} atomic aborts, {st3.refreshes} refreshes)")
    print("escrow audit:", assert_audit(s3, escrow=esc, initial_stock=q0,
                                        strict_stock=True).describe())

    two_strict = plan_engine(scale, stock_invariant="serial", device=dev)
    s4 = plump()
    q04 = s4.s_quantity.clone()
    s4, st4 = run_closed_loop_2pc(
        two_strict, s4, batch_per_shard=args.batch_per_shard,
        n_batches=args.batches, remote_frac=args.remote_frac,
        commit_latency_s=per_batch)
    thr4 = st4.committed / max(st4.wall_seconds, 1e-9)
    print(f"2PC strict: {thr4:,.0f} committed txn/s "
          f"({st4.aborted} aborts, incl. commitment latency)")
    print("2PC strict audit:", assert_audit(s4, initial_stock=q04,
                                            strict_stock=True).describe())
    print(f"\nescrow over strict-2PC speedup: "
          f"{st3.neworders / st3.wall_seconds / max(thr4, 1e-9):.1f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
