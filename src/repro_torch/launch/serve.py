"""Serving launcher: batched generation with coordination-free bookkeeping,
on the CUDA card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --reduced --device cpu --requests 16 --new-tokens 8

Every arch of the registry serves through it (the six families); without
``--reduced`` at its published width and depth.

The flags and the prompt draws are the reference launcher's
(``repro.launch.serve``); the weights are random, from seed 0.
"""

from __future__ import annotations

import argparse
import time


def run(argv=None) -> dict:
    """Serve ``--requests`` seeded prompts in static batches of ``--batch``
    and print the plan, the throughput and the bookkeeping. Returns the
    server, the served requests and the run's counts and times."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--budget", type=float, default=1e6)
    ap.add_argument("--servers", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core.planner import plan_states, serving_state_specs
    from repro_torch.device import resolve_device
    from repro_torch.runtime.serve import ServeConfig, Server

    device = resolve_device(args.device)
    print(plan_states(serving_state_specs()).summary())

    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = registry.init_params(cfg, 0, device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model: {cfg.name} ({cfg.family}), {n_params:,} parameters")
    srv = Server(cfg, params, ServeConfig(
        max_batch=args.batch, capacity=args.capacity,
        max_new_tokens=args.new_tokens, admission_budget=args.budget,
        n_servers=args.servers), device=device)

    rng = np.random.default_rng(0)
    pending = []
    shed = 0
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              rng.integers(2, args.prompt_len + 1)).astype(
                                  np.int32)
        req = srv.admit(prompt)
        if req is None:
            shed += 1
        else:
            pending.append(req)

    t0 = time.perf_counter()
    served = []
    while pending:
        batch, pending = pending[:args.batch], pending[args.batch:]
        served += srv.serve_batch(batch)
    dt = time.perf_counter() - t0
    done = len(served)
    rep = srv.report()
    tok_s = done * args.new_tokens / max(dt, 1e-9)
    print(f"served {done} requests ({shed} shed by escrow admission) in "
          f"{dt:.2f}s -> {tok_s:.1f} tok/s on {device}")
    for i, t in enumerate(srv.timings):
        print(f"batch {i}: {t.batch} sequences, prefill of {t.prefix} tokens "
              f"{t.prefill_s * 1e3:.1f} ms, decode "
              f"{t.decode_s * 1e3 / max(t.steps, 1):.2f} ms a token")
    print(f"bookkeeping: {rep}")
    return dict(server=srv, requests=served, served=done, shed=shed,
                seconds=dt, tok_s=tok_s, report=rep, n_params=n_params)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
