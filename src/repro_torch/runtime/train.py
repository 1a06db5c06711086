"""Training runtime: a coordination-planned loop with checkpoint/restart
and a deferred merge cadence — the port of ``repro.runtime.train``.

The loop consults the CoordinationPlan (``core/planner.py``): merges follow
the plan's ``merge_every`` (deferred modes), metrics are read only at log
boundaries (G-counter slots), checkpoints use temp-ID saves with
commit-time sequential renaming, and a restart resumes from the newest
complete manifest, the pipeline's cursors with it.

On one card ``run`` takes ``n_pods`` where the reference takes the mesh
(the data and model axes are 1), and runs on the card unless ``device``
says otherwise.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.core import planner
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import synchronize
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, coord


@dataclasses.dataclass
class TrainConfig:
    steps: int = 50
    log_every: int = 10
    ckpt_every: int = 0            # 0 = no checkpoints
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    coord: coord.CoordConfig = dataclasses.field(
        default_factory=coord.CoordConfig)
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    remat: bool = True


def coordination_plan(cfg: TrainConfig) -> planner.CoordinationPlan:
    """The static I-confluence analysis of this training configuration."""
    return planner.plan_states(planner.training_state_specs(
        coord_mode=cfg.coord.mode, merge_every=cfg.coord.merge_every,
        exact_clip=(cfg.opt.clip_mode == "exact")))


def validate_plan(cfg: TrainConfig) -> None:
    """Refuse configurations the analyzer marks unsafe: exact global-norm
    clipping needs a synchronous all-reduce, which deferred modes forbid."""
    if cfg.coord.deferred and cfg.opt.clip_mode == "exact":
        plan = coordination_plan(cfg)
        entry = plan.entry("grad_norm")
        raise ValueError(
            "coordination plan violation: exact clipping is "
            f"{entry.coord_class.value} but mode={cfg.coord.mode} defers "
            "cross-replica coordination; use clip_mode='escrow' (paper §8)")


def run(model_cfg: ModelConfig, cfg: TrainConfig, *, n_pods: int = 1,
        restore_from: Optional[str] = None,
        on_step: Optional[Callable] = None,
        device=None) -> tuple[coord.TrainState, dict]:
    """Train for cfg.steps on ``n_pods`` pods; returns (final state,
    summary metrics)."""
    validate_plan(cfg)
    setup = coord.build(
        model_cfg, cfg.coord, cfg.opt,
        lambda c: registry.make_loss_fn(c, remat=cfg.remat),
        n_pods=n_pods, device=device)

    pipe = Pipeline(DataConfig(model_cfg.vocab, cfg.seq_len, cfg.global_batch,
                               cfg.seed, n_shards=n_pods), model_cfg)

    state = setup.init_fn(cfg.seed)
    start_step = 0
    if restore_from:
        man = ckpt.latest_manifest(restore_from)
        if man is not None and ckpt.is_complete(man, setup.abstract_state):
            state = ckpt.restore(restore_from, man, setup.abstract_state,
                                 setup.device)
            start_step = man.step
            pipe.restore({"cursors": [man.step * pipe.per_shard]
                          * pipe.cfg.n_shards, "n_shards": pipe.cfg.n_shards})

    history = []
    t0 = time.perf_counter()
    for step in range(start_step, cfg.steps):
        state = setup.step_fn(state, pipe.next_batch())
        if setup.merge_fn is not None and \
                (step + 1) % cfg.coord.merge_every == 0:
            state = setup.merge_fn(state)   # deferred cross-pod anti-entropy
        if (step + 1) % cfg.log_every == 0:
            m = setup.read_metrics(state)   # G-counter log-boundary read
            history.append(m)
            if on_step:
                on_step(m)
        if cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
            man = ckpt.save(cfg.ckpt_dir, state, step + 1)
            if ckpt.is_complete(man, setup.abstract_state):
                ckpt.assign_sequential(cfg.ckpt_dir, man)

    # final merge so replicas converge before the run ends (Definition 3)
    if setup.merge_fn is not None:
        state = setup.merge_fn(state)
    synchronize(setup.device)
    wall = time.perf_counter() - t0

    summary = setup.read_metrics(state)
    summary["wall_seconds"] = wall
    summary["history"] = history
    return state, summary
