"""Coordination-avoiding data parallelism on pods of one card — the port
of the reference's ``examples/coord_dp.py``, with its sections, and
``--pods`` (default 2) in place of its 8-device 2 x 2 x 2 mesh.

Shows the paper's execution model applied to training:
  * sync mode     — one replica: the step takes the whole global batch's
    gradient at once, so on one card it calls no collective (on the
    reference's mesh its gradient all-reduce crosses pods every step);
  * hierarchical  — each pod a replica on its block of the batch: the hot
    path calls ZERO collectives, hence none across pods (counted by
    ``txn/collectives.counted()`` around a step); the deferred merge is
    the only cross-pod traffic, amortized over ``merge_every`` steps and
    optionally int8-compressed;
  * both modes converge (loss goes down either way).

    PYTHONPATH=src python -m repro_torch.launch.coord_dp --device cpu

Without ``--device`` it runs on the CUDA card.
"""

from __future__ import annotations

import argparse

MODES = (("sync", "none"), ("hierarchical", "none"),
         ("hierarchical", "int8"))


def _mb(stats) -> float:
    return sum(stats.bytes.values()) / 1e6


def run(argv=None) -> dict:
    """Each mode's step and merge collectives and its losses; returns them
    by mode."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.optim import adamw, coord
    from repro_torch.txn import collectives

    device = resolve_device(args.device)
    cfg = registry.get_config("smollm-360m").reduced()
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=60)
    gen = torch.Generator(device=device).manual_seed(1)
    batch = registry.make_train_batch(gen, cfg, 8, 32)

    out = {}
    for mode, compress in MODES:
        cc = coord.CoordConfig(mode=mode, merge_every=4, compress=compress)
        setup = coord.build(cfg, cc, opt_cfg,
                            lambda c: registry.make_loss_fn(c, remat=False),
                            n_pods=args.pods, device=device)
        state = setup.init_fn(0)
        losses, step_stats, merge_stats = [], None, None
        prev_total = 0.0
        for i in range(args.steps):
            with collectives.counted() as stats:
                state = setup.step_fn(state, batch)
            step_stats = step_stats or stats
            if setup.merge_fn is not None and (i + 1) % cc.merge_every == 0:
                with collectives.counted() as stats:
                    state = setup.merge_fn(state)
                merge_stats = merge_stats or stats
            total = float(state.loss_slots.sum())
            losses.append(total - prev_total)
            prev_total = total
        # every collective of the port crosses pods (txn/collectives.py)
        cross = step_stats.total_ops if args.pods > 1 else 0
        print(f"\n== {mode} (compress={compress}) ==")
        print(f"  step: {step_stats.total_ops} collectives "
              f"({_mb(step_stats):.2f} MB), cross-pod: {cross}"
              + ("   <- hot path never leaves the pod" if not cross else ""))
        if merge_stats is not None:
            print(f"  merge: {merge_stats.total_ops} collectives "
                  f"({_mb(merge_stats):.2f} MB), cross-pod: "
                  f"{merge_stats.total_ops if args.pods > 1 else 0}  "
                  f"[runs every {cc.merge_every} steps]")
        n_pods = state.loss_slots.shape[0]
        print(f"  loss (per step, summed over {n_pods} pod slot(s)): "
              f"{losses[0]:.3f} -> {losses[-1]:.3f}")
        out[(mode, compress)] = dict(step=step_stats, merge=merge_stats,
                                     losses=losses)
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
