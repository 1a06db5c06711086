"""Train a language model end to end (a reduced config) with the
coordination-planned runtime: data pipeline, AdamW, escrow clipping,
checkpoints with deferred sequential IDs, restart — the port of the
reference's ``examples/train_lm.py``, with its flags.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \\
        [--arch smollm-360m]

Without ``--device`` it runs on the CUDA card. The reference's mesh of
one device per axis is the port's one pod.
"""

from __future__ import annotations

import argparse
import tempfile


def run(argv=None) -> dict:
    """Train, print the plan and the losses, restart from the committed
    checkpoint and train on; returns both runs' summaries."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.optim import adamw, coord
    from repro_torch.runtime import train as train_rt

    device = resolve_device(args.device)
    cfg = registry.get_config(args.arch).reduced()

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tc = train_rt.TrainConfig(
            steps=args.steps, log_every=5, ckpt_every=10, ckpt_dir=ckpt_dir,
            seq_len=args.seq, global_batch=args.batch, remat=False,
            opt=adamw.AdamWConfig(lr=1e-3, clip_mode="escrow",
                                  warmup_steps=5, total_steps=args.steps),
            coord=coord.CoordConfig(mode="sync"))

        print(train_rt.coordination_plan(tc).summary(), "\n")

        def log(m):
            print(f"step {m['step']:4d}  loss {m['loss_mean']:.4f}  "
                  f"grad_norm {m['grad_norm_last']:.3f}")

        _, summary = train_rt.run(cfg, tc, on_step=log, device=device)
        first = summary["history"][0]["loss_mean"]
        last = summary["history"][-1]["loss_mean"]
        print(f"\nloss {first:.3f} -> {last:.3f} over {summary['step']} "
              f"steps ({summary['tokens']:.0f} tokens, "
              f"{summary['wall_seconds']:.1f}s) on {device}")

        # restart from the sequential checkpoint and keep going
        tc2 = train_rt.TrainConfig(
            steps=args.steps + 10, log_every=5, ckpt_dir=ckpt_dir,
            seq_len=args.seq, global_batch=args.batch, remat=False,
            opt=tc.opt, coord=tc.coord)
        _, summary2 = train_rt.run(cfg, tc2, restore_from=ckpt_dir,
                                   on_step=log, device=device)
        print(f"resumed to step {summary2['step']} "
              f"(restart from committed checkpoint)")
    return dict(summary=summary, resumed=summary2)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
