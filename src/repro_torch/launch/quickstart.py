"""Quickstart: the paper's core loop in five minutes — the port of the
reference's ``examples/quickstart.py``, with its sections.

1. Declare invariants + transactions (the payroll app of paper §2).
2. Run the static I-confluence analyzer (Table 2 rules).
3. Watch Theorem 1 play out dynamically: confluent ops survive randomized
   diamond executions; non-confluent ones produce a concrete witness.
4. Build the coordination plan for an LM training loop and see which state
   needs a synchronous collective vs an asynchronous merge.

    PYTHONPATH=src python -m repro_torch.launch.quickstart

Everything here is analysis on the host: nothing of it runs on a device,
so it takes no ``--device``.
"""

from __future__ import annotations

SYSTEMS = ("counter_incr", "counter_decr", "counter_escrow",
           "uniqueness_specific", "uniqueness_some")


def run(argv=None) -> dict:
    """Print the four sections; return what they printed from (Table 2's
    rows, the payroll verdicts, each system's witness or trials, the
    plan)."""
    import argparse

    from repro_torch.core import (analyze_application,
                                  check_confluence_empirically, plan_states,
                                  search_witness, table2,
                                  training_state_specs)
    from repro_torch.core.invariants import payroll_invariants
    from repro_torch.core.systems import (ALL_SYSTEM_FACTORIES,
                                          payroll_transactions)

    argparse.ArgumentParser().parse_args(argv)
    rule = "=" * 72
    print(rule)
    print("1. Table 2 — static I-confluence classification")
    print(rule)
    rows = table2()
    for row in rows:
        mark = "✓" if row["match"] else "✗"
        print(f"  {mark} {row['invariant']:22s} × {row['operation']:24s} "
              f"-> {'confluent' if row['analyzer'] else 'NOT confluent':14s} "
              f"[{row['strategy']}]")

    print()
    print(rule)
    print("2. The payroll application (paper §2)")
    print(rule)
    reports = analyze_application(payroll_transactions(),
                                  payroll_invariants())
    for name, rep in reports.items():
        print(f"  {'✓' if rep.coordination_free else '✗'} {name}: "
              f"{'coordination-free' if rep.coordination_free else 'must coordinate'}")

    print()
    print(rule)
    print("3. Theorem 1, dynamically (diamond executions, Fig. 2)")
    print(rule)
    dynamics = {}
    for name in SYSTEMS:
        system = ALL_SYSTEM_FACTORIES[name]()
        witness = search_witness(system, seed=1, max_trials=1500)
        if witness is None:
            rep = check_confluence_empirically(system, trials=200)
            dynamics[name] = rep
            print(f"  ✓ {system.name:24s} no violation in "
                  f"{rep['trials']} diamonds ({rep['committed_txns']} "
                  f"commits)")
        else:
            dynamics[name] = witness
            print(f"  ✗ {system.name:24s} witness: {witness.describe()}")

    print()
    print(rule)
    print("4. Coordination plan for the LM training loop")
    print(rule)
    plan = plan_states(training_state_specs(coord_mode="hierarchical",
                                            merge_every=8))
    print(plan.summary())
    return dict(table2=rows, payroll=reports, dynamics=dynamics, plan=plan)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
