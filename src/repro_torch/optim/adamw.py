"""AdamW over a tree of tensors, with escrow or exact gradient clipping —
the port of ``repro.optim.adamw``.

Clipping modes map to the coordination plan (``core/planner.py``):
  * "exact"  — true global-norm clip; in sync data-parallel mode the global
    norm falls out of the already-reduced gradients (no extra collective);
    in deferred/pod-replica modes it would require a cross-pod all-reduce,
    so the planner forbids it there;
  * "escrow" — paper §8: each of R replicas clips against its share
    tau/sqrt(R) of the clip budget; ||g_global|| <= tau is then guaranteed by
    the L2 composition of disjoint shards (sum of squares), with zero
    coordination;
  * "none".

Everything stays on the tensors' device: the step count is a 0-d int32
tensor and the learning rate, the bias corrections and the clip scale are
float32 tensors computed from it, so a step makes no host read. Leaves are
walked in the reference's order (``core.tree``), so the global norm sums
them in the same order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import tree as T

PyTree = Any


class AdamWState(NamedTuple):
    mu: PyTree
    nu: PyTree
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    clip_mode: str = "escrow"   # exact | escrow | none
    num_replicas: int = 1       # escrow share divisor (R)
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init(params: PyTree) -> AdamWState:
    """Zero moments (float32) of the parameters' shapes, count 0, on the
    parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = T.leaves(params)[0].device
    return AdamWState(T.map(zeros, params), T.map(zeros, params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * cos


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in T.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_grads(grads: PyTree, cfg: AdamWConfig
               ) -> tuple[PyTree, torch.Tensor]:
    """Returns (clipped grads, pre-clip norm)."""
    norm = global_norm(grads)
    if cfg.clip_mode == "none":
        return grads, norm
    f32 = lambda v: torch.full((), v, dtype=torch.float32,
                               device=norm.device)
    if cfg.clip_mode == "escrow":
        # local share of the global budget (paper §8): tau_local = tau/sqrt(R)
        budget = cfg.clip_norm / torch.sqrt(f32(cfg.num_replicas))
    else:  # exact
        budget = f32(cfg.clip_norm)
    scale = torch.clamp(budget / torch.clamp(norm, min=1e-9), max=1.0)
    return T.map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                grads), norm


def update(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
           params: PyTree) -> tuple[PyTree, AdamWState, dict]:
    """One AdamW step: new (params, state, {"grad_norm", "lr"}), each a new
    tensor (the inputs are left as they are)."""
    grads, pre_norm = clip_grads(grads, cfg)
    count = state.count + 1
    c = count.to(torch.float32)
    b1c = 1 - cfg.b1 ** c
    b2c = 1 - cfg.b2 ** c
    lr = lr_at(cfg, count)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        mh = m / b1c
        vh = v / b2c
        step = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), m, v

    flat_p, treedef = T.flatten(params)
    flat_g = T.flatten_up_to(treedef, grads)
    flat_m = T.flatten_up_to(treedef, state.mu)
    flat_v = T.flatten_up_to(treedef, state.nu)
    out = [upd(*xs) for xs in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p, new_m, new_v = (T.unflatten(treedef, [o[i] for o in out])
                           for i in range(3))
    metrics = {"grad_norm": pre_norm, "lr": lr}
    return new_p, AdamWState(new_m, new_v, count), metrics
