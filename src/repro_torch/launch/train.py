"""Training launcher, on the CUDA card unless ``--device cpu`` is given.

Examples (CPU-sized):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --device cpu --steps 20 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --device cpu --coord hierarchical --merge-every 4 \\
      --compress int8 --pods 2

On the card drop ``--device`` (and ``--reduced`` for the published width
and depth). The flags are the reference launcher's (``repro.launch.train``)
but for its ``--mesh pod,data,model`` and ``--devices``, which have no
meaning on one card: ``--pods N`` sets the pod count (the data and model
axes are 1).
"""

from __future__ import annotations

import argparse


def run(argv=None) -> dict:
    """Train as the flags say; print the coordination plan, the log lines
    and the throughput. Returns the plan, the final state and the
    summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--coord", default="sync",
                    choices=["sync", "hierarchical", "local_sgd"])
    ap.add_argument("--merge-every", type=int, default=8)
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--clip-mode", default="escrow",
                    choices=["escrow", "exact", "none"])
    ap.add_argument("--pods", type=int, default=1,
                    help="pod replicas on the one card (the reference's "
                         "--mesh pod axis; its data and model axes and "
                         "--devices have no meaning on one card)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--restore", default="")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--attn", default="naive", choices=["naive", "chunked"])
    ap.add_argument("--plan-only", action="store_true",
                    help="print the coordination plan and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.optim import adamw, coord
    from repro_torch.runtime import train as train_rt

    device = resolve_device(args.device)
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.attn != "naive":
        cfg = dataclasses.replace(cfg, attn_impl=args.attn)

    tc = train_rt.TrainConfig(
        steps=args.steps, log_every=args.log_every,
        ckpt_every=args.ckpt_every, seq_len=args.seq,
        global_batch=args.batch,
        coord=coord.CoordConfig(mode=args.coord,
                                merge_every=args.merge_every,
                                compress=args.compress),
        opt=adamw.AdamWConfig(lr=args.lr, clip_mode=args.clip_mode,
                              warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps),
        remat=not args.reduced)
    if args.ckpt_dir:
        tc.ckpt_dir = args.ckpt_dir

    plan = train_rt.coordination_plan(tc)
    print(plan.summary())
    if args.plan_only:
        return dict(plan=plan)

    def log(m):
        print(f"step {m['step']:5d}  loss {m['loss_mean']:.4f}  "
              f"tokens {m['tokens']:.0f}  grad_norm {m['grad_norm_last']:.3f}",
              flush=True)

    state, summary = train_rt.run(cfg, tc, n_pods=args.pods,
                                  restore_from=args.restore or None,
                                  on_step=log, device=device)
    print(f"done: {summary['step']} steps in {summary['wall_seconds']:.1f}s "
          f"({summary['tokens'] / max(summary['wall_seconds'], 1e-9):.0f} "
          f"tok/s) on {device}")
    return dict(plan=plan, state=state, summary=summary)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
