"""Coordination-avoiding data parallelism — the paper's technique as the
training loop's execution engine; the port of ``repro.optim.coord``.

The coordination plan (``core/planner.py``) classifies training state;
this module realizes the three execution modes:

  * ``sync`` — the coordinated baseline (the "serializable" analog): one
    global step, gradients of the whole global batch every step.
  * ``hierarchical`` — replicas = pods (paper Fig. 1): parameters carry a
    leading pod dimension and diverge; each pod steps on its own block of
    the global batch; the cross-pod merge is DEFERRED to every k-th step
    and runs as an explicit anti-entropy ``merge_fn`` — convergence may
    lag the hot path (Definition 3), optionally compressed
    (``optim/compression.py``).
  * ``local_sgd`` — same mechanics with a long merge period.

Metric state is G-counters: per-pod slots, summed only when read (merge at
log boundaries — the planner's merge_every=0 class).

On one card ``build`` takes ``n_pods`` where the reference takes the
(pod, data, model) mesh, and loops over the pods in Python, as the TPC-C
engine loops over its shards: pod i's parameters and moments are block i
of every leaf's leading dim, and its batch is block i of the global batch
(what ``shard_map``'s ``P(pod)`` gives it). The mesh, ``Rules``, the
shardings, ``shard_map`` and ``_under_mesh`` have no eager counterpart and
are not ported; only the merge crosses pods, through ``txn.collectives``.
The step's hot path calls no collective in any mode.

Gradients are those of the float32 masters in the reference's tree layout
(``layers.stacked``): each step takes them with ``torch.autograd.grad`` of
leaves detached from the state, so the state never carries a graph and a
serving model is never made to require gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs import registry
from repro_torch.core import tree as T
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

from . import adamw, compression

PyTree = Any


@dataclasses.dataclass(frozen=True)
class CoordConfig:
    mode: str = "sync"            # sync | hierarchical | local_sgd
    merge_every: int = 8          # cadence of the deferred cross-pod merge
    compress: str = "none"        # none | bf16 | int8
    merge_opt_state: bool = True  # also average Adam moments at merge time
    microbatch: int = 1           # gradient-accumulation steps per update
                                  # (activation memory divides by this)

    @property
    def deferred(self) -> bool:
        return self.mode in ("hierarchical", "local_sgd")


class TrainState(NamedTuple):
    params: PyTree
    opt: adamw.AdamWState
    step: torch.Tensor            # [] int32 (identical local increments)
    loss_slots: torch.Tensor      # [n_pods] float32 G-counter slots
    token_slots: torch.Tensor     # [n_pods] float32
    grad_norm_slots: torch.Tensor  # [n_pods] float32 (last local grad norm)


@dataclasses.dataclass
class TrainSetup:
    step_fn: Callable
    merge_fn: Optional[Callable]
    init_fn: Callable             # seed -> TrainState on the device
    coord: CoordConfig
    device: torch.device
    abstract_state: Any = None    # the initial state as meta tensors

    def read_metrics(self, state: TrainState) -> dict:
        """G-counter reads: sum the per-pod slots (log-boundary merge)."""
        return {
            "step": int(state.step),
            "loss_mean": float(state.loss_slots.sum())
            / max(int(state.step), 1) / max(state.loss_slots.shape[0], 1),
            "tokens": float(state.token_slots.sum()),
            "grad_norm_last": float(state.grad_norm_slots.max()),
        }


def value_and_grad(loss_fn: Callable, params: PyTree, batch: dict
                   ) -> tuple[torch.Tensor, PyTree]:
    """``loss_fn(params, batch)`` and its gradient tree (a leaf the loss
    does not reach gets zeros, as in JAX); ``params`` is left as it is."""
    leaves, treedef = T.flatten(params)
    req = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(T.unflatten(treedef, req), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(req, grads)]
    return loss.detach(), T.unflatten(treedef, grads)


def _token_count(batch: dict) -> torch.Tensor:
    t = batch["tokens"]
    return torch.full((), t.shape[0] * t.shape[1], dtype=torch.float32,
                      device=t.device)


def build(model_cfg, coord: CoordConfig, opt_cfg: adamw.AdamWConfig,
          make_loss_fn: Callable, *, n_pods: int = 1,
          device=None) -> TrainSetup:
    """Assemble the step and merge functions for the chosen mode, on
    ``device`` (the card unless it says otherwise).

    ``make_loss_fn(model_cfg)`` -> loss(params, batch). ``n_pods`` is the
    number of pods (the reference's ``pod`` mesh axis); the escrow clip
    share divides by it in every mode, as the reference's does."""
    dev = resolve_device(device)
    opt_cfg = dataclasses.replace(opt_cfg, num_replicas=n_pods)
    loss_fn = make_loss_fn(model_cfg)
    if not coord.deferred:
        return _build_sync(model_cfg, coord, opt_cfg, loss_fn, dev)
    return _build_deferred(model_cfg, coord, opt_cfg, loss_fn, n_pods, dev)


def _initial_params(model_cfg, seed: int, device) -> PyTree:
    return L.stacked(registry.init_params(model_cfg, seed, device))


def _on(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# sync (coordinated baseline)
# ---------------------------------------------------------------------------


def _build_sync(model_cfg, coord, opt_cfg, loss_fn, dev) -> TrainSetup:
    def init_fn(seed: int, device=dev) -> TrainState:
        params = _initial_params(model_cfg, seed, device)
        z = lambda: torch.zeros((1,), dtype=torch.float32, device=device)
        return TrainState(params, adamw.init(params),
                          torch.zeros((), dtype=torch.int32, device=device),
                          z(), z(), z())

    n_micro = max(coord.microbatch, 1)

    def _grads(params, batch):
        if n_micro == 1:
            return value_and_grad(loss_fn, params, batch)
        # gradient accumulation over microbatches, float32 accumulators
        micro = [{k: v.reshape((n_micro, v.shape[0] // n_micro)
                               + v.shape[1:])[j] for k, v in batch.items()}
                 for j in range(n_micro)]
        leaves, treedef = T.flatten(params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        for mb in micro:
            loss, g = value_and_grad(loss_fn, params, mb)
            loss_sum = loss_sum + loss
            acc = [a + x.to(torch.float32) for a, x in zip(acc, T.leaves(g))]
        return loss_sum / n_micro, T.unflatten(treedef, [
            (a / n_micro).to(p.dtype) for a, p in zip(acc, leaves)])

    def step_fn(state: TrainState, batch: dict) -> TrainState:
        batch = _on(batch, dev)
        loss, grads = _grads(state.params, batch)
        params, opt, m = adamw.update(opt_cfg, grads, state.opt,
                                      state.params)
        return TrainState(
            params, opt, state.step + 1,
            state.loss_slots + loss,
            state.token_slots + _token_count(batch),
            m["grad_norm"].reshape(1))

    return TrainSetup(step_fn, None, init_fn, coord, dev, init_fn(0, "meta"))


# ---------------------------------------------------------------------------
# deferred (hierarchical / local_sgd): pod-replicated parameters
# ---------------------------------------------------------------------------


def _build_deferred(model_cfg, coord, opt_cfg, loss_fn, n_pods,
                    dev) -> TrainSetup:
    def init_fn(seed: int, device=dev) -> TrainState:
        params = _initial_params(model_cfg, seed, device)
        # one copy per pod (leading pod dim); identical at t=0
        params = T.map(lambda x: x.expand(n_pods, *x.shape).clone(),
                       params)
        opt = adamw.init(params)  # moments carry the pod dim too
        z = lambda: torch.zeros((n_pods,), dtype=torch.float32,
                                device=device)
        return TrainState(params, opt,
                          torch.zeros((), dtype=torch.int32, device=device),
                          z(), z(), z())

    # -- hot path: each pod on its block of the batch, no collective --------
    def step_fn(state: TrainState, batch: dict) -> TrainState:
        batch = _on(batch, dev)
        per = batch["tokens"].shape[0] // n_pods
        p_leaves, treedef = T.flatten(state.params)
        m_leaves = T.leaves(state.opt.mu)
        v_leaves = T.leaves(state.opt.nu)
        new = [[torch.empty_like(x) for x in leaves]
               for leaves in (p_leaves, m_leaves, v_leaves)]
        losses, tokens, norms = [], [], []
        count = state.opt.count
        for i in range(n_pods):
            pod = lambda leaves: T.unflatten(treedef, [x[i] for x in leaves])
            local = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            params = pod(p_leaves)
            loss, grads = value_and_grad(loss_fn, params, local)
            params, opt, m = adamw.update(
                opt_cfg, grads,
                adamw.AdamWState(pod(m_leaves), pod(v_leaves),
                                 state.opt.count), params)
            for out, tree in zip(new, (params, opt.mu, opt.nu)):
                for dst, x in zip(out, T.leaves(tree)):
                    dst[i].copy_(x)
            count = opt.count
            losses.append(loss)
            tokens.append(_token_count(local))
            norms.append(m["grad_norm"])
        return TrainState(
            T.unflatten(treedef, new[0]),
            adamw.AdamWState(T.unflatten(treedef, new[1]),
                             T.unflatten(treedef, new[2]), count),
            state.step + 1,
            state.loss_slots + torch.stack(losses),
            state.token_slots + torch.stack(tokens),
            torch.stack(norms))

    # -- anti-entropy: explicit cross-pod merge ------------------------------
    def merge_fn(state: TrainState) -> TrainState:
        params = compression.merge_mean(state.params, coord.compress)
        opt = state.opt
        if coord.merge_opt_state:
            opt = adamw.AdamWState(
                compression.merge_mean(opt.mu, coord.compress),
                compression.merge_mean(opt.nu, coord.compress),
                opt.count)
        return state._replace(params=params, opt=opt)

    return TrainSetup(step_fn, merge_fn, init_fn, coord, dev,
                      init_fn(0, "meta"))
