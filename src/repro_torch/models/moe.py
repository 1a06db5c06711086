"""Mixture-of-Experts FFN (qwen3-moe-30b-a3b, olmoe-1b-7b) with sort-based
dispatch — the port of ``repro.models.moe``, for serving.

Dispatch, step for step as in the reference:
  1. top-k routing per token: a stable descending sort of the router's
     probabilities, so that tied experts go to the lower index, as in
     ``lax.top_k`` (``torch.topk`` promises no order among ties);
  2. the assignments sorted by expert id with a stable argsort (as
     ``jnp.argsort``), a rank within its expert from each expert's first
     sorted offset; the assignments past an expert's capacity are
     dropped (Switch/GShard), so which one a full expert drops is the
     reference's;
  3. the kept tokens gathered into a dense [E, capacity, d] block and the
     expert FFN run as batched matmuls over E;
  4. the combine: each token's k weighted contributions summed one add at
     a time from zero, in the sorted order (by expert id). That is the
     order of the reference's ``.at[src_token].add`` on the CPU, and it
     uses no atomics, so two runs on the card agree bit for bit.

The reference's ``moe_apply_a2a`` and ``_pack_by_key`` (a ``shard_map``
all-to-all over an expert mesh axis) have no counterpart on one card and
are not ported; without an expert axis the reference's chooser
(``moe_ffn``) falls back to ``moe_apply``, which the layers here call.

The decoder's attention is the dense family's (``transformer``). A
serving prefill (``prefill`` with ``use_flash``) runs kernel B5 once a
layer on the card.

``loss_fn`` is the cross-entropy plus the router's load-balancing loss
summed over the layers, as the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import kv_cache as kvc
from . import layers as L
from . import transformer as T
from .config import ModelConfig


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> L.Params:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.ffn_width()
    s_in, s_out = d ** -0.5, ff ** -0.5
    return L.Params(router=L.normal(gen, (d, E), s_in),
                    w1=L.normal(gen, (E, d, ff), s_in),
                    w3=L.normal(gen, (E, d, ff), s_in),
                    w2=L.normal(gen, (E, ff, d), s_out))


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor      # scalar load-balance loss
    expert_load: torch.Tensor   # [E] int32 assignments routed per expert
    dropped: torch.Tensor       # scalar int32 dropped-assignment count


def _dispatch_ffn(p: L.Params, xf: torch.Tensor, cfg: ModelConfig, cap: int
                  ) -> tuple[torch.Tensor, ...]:
    """The routed FFN over a flat token block xf [T, d], ``cap``
    assignments an expert. Returns (out [T, d], aux, load [E], dropped);
    the caller picks the block (global or a sequence, ``moe_apply``)."""
    T_, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = xf.device

    # routing
    probs = torch.softmax(xf.float() @ p.router, dim=-1)        # [T, E]
    gate_vals, experts = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    gate_vals, experts = gate_vals[:, :k], experts[:, :k]       # [T, k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    # aux loss (Switch): E * sum_e fraction_e * prob_e
    fraction = F.one_hot(experts[:, 0], E).float().mean(0)
    aux = E * torch.sum(fraction * probs.mean(0)) * cfg.router_aux_coef

    # sort-based dispatch
    A = T_ * k
    flat_expert = experts.reshape(A)
    order = torch.argsort(flat_expert, stable=True)             # [A]
    sorted_e = flat_expert[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank = torch.arange(A, device=dev) - first[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank, E * cap)    # overflow
    src_token = order // k                 # the token of each assignment

    # gather tokens into expert blocks (one dummy overflow row)
    xg = xf.new_zeros((E * cap + 1, d))
    xg[slot] = xf[src_token]
    xg = xg[:-1].reshape(E, cap, d)

    # the expert FFN (grouped matmuls)
    h = F.silu(torch.bmm(xg, p.w1.to(xf.dtype))) * \
        torch.bmm(xg, p.w3.to(xf.dtype))
    y = torch.bmm(h, p.w2.to(xf.dtype)).reshape(E * cap, d)

    # combine: a token's contributions in sorted order, added one by one
    y_sorted = torch.where(keep[:, None],
                           y[torch.clamp_max(slot, E * cap - 1)], 0.0)
    contrib = y_sorted * gate_vals.reshape(A)[order][:, None].to(xf.dtype)
    where = torch.empty_like(order)
    where[order] = torch.arange(A, device=dev)        # sorted position
    mine = contrib[torch.sort(where.reshape(T_, k), dim=-1).values]
    out = xf.new_zeros((T_, d))
    for j in range(k):
        out = out + mine[:, j]

    load = torch.bincount(flat_expert, minlength=E).to(torch.int32)
    return out, aux, load, (~keep).sum().to(torch.int32)


def moe_apply(p: L.Params, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, MoEStats]:
    """x [B, S, d] -> ([B, S, d], stats), at one of the reference's two
    granularities (``cfg.moe_block_dispatch``): one dispatch over all B S
    tokens, capacity ``round(capacity_factor T k / E)``, or one a
    sequence, capacity ``round(capacity_factor S k / E)``."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    if cfg.moe_block_dispatch and B > 1:
        cap = int(max(1, round(cfg.capacity_factor * S * k / E)))
        outs = [_dispatch_ffn(p, xb, cfg, cap) for xb in x]
        out, aux, load, dropped = (torch.stack(z) for z in zip(*outs))
        return out, MoEStats(aux.mean(), load.sum(0).to(torch.int32),
                             dropped.sum().to(torch.int32))
    T_ = B * S
    cap = int(max(1, round(cfg.capacity_factor * T_ * k / E)))
    out, aux, load, dropped = _dispatch_ffn(p, x.reshape(T_, d), cfg, cap)
    return out.reshape(B, S, d), MoEStats(aux, load, dropped)


# ---------------------------------------------------------------------------
# MoE decoder (dense attention + MoE FFN)
# ---------------------------------------------------------------------------


def layer_init(gen: torch.Generator, cfg: ModelConfig) -> L.Params:
    return L.Params(
        attn_norm=L.rmsnorm_init(cfg.d_model, gen.device),
        attn=L.attention_init(gen, cfg),
        mlp_norm=L.rmsnorm_init(cfg.d_model, gen.device),
        moe=moe_init(gen, cfg))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> L.Params:
    """Random float32 master weights from a seeded ``torch.Generator`` on
    ``device`` (the card unless ``device`` says otherwise)."""
    gen = L.generator(device, seed)
    params = L.embedding_init(gen, cfg)
    params.layers = nn.ModuleList(layer_init(gen, cfg)
                                  for _ in range(cfg.n_layers))
    params.final_norm = L.rmsnorm_init(cfg.d_model, gen.device)
    return params


def layer_apply(lp: L.Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, use_flash: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    h = L.attention_apply(lp.attn, L.rmsnorm(lp.attn_norm, x, cfg.norm_eps),
                          cfg, positions, causal=True, use_flash=use_flash)
    x = x + h
    h, stats = moe_apply(lp.moe, L.rmsnorm(lp.mlp_norm, x, cfg.norm_eps), cfg)
    return x + h, stats.aux_loss


def forward(params: L.Params, tokens: torch.Tensor, cfg: ModelConfig,
            use_flash: bool = False, last_only: bool = False,
            remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, total aux loss)."""
    x = L.embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    apply_one = L.remat(lambda lp, c: layer_apply(lp, c, cfg, positions,
                                                  use_flash), remat)
    aux = []
    for lp in params.layers:
        x, a = apply_one(lp, x)
        aux.append(a)
    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.logits(params, x, cfg), torch.stack(aux).sum()


def loss_fn(params: L.Params, batch: dict, cfg: ModelConfig,
            remat: bool = True) -> torch.Tensor:
    lg, aux = forward(params, batch["tokens"], cfg, remat=remat)
    return L.cross_entropy(lg, batch["labels"]) + aux


# -- serving: the dense attention cache; the MoE runs on each token's block --


def _finish_layer(lp: L.Params, x: torch.Tensor, out: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The attention output projection, the residual and the MoE FFN."""
    x = T.attn_residual(lp, x, out)
    h, _ = moe_apply(lp.moe, L.rmsnorm(lp.mlp_norm, x, cfg.norm_eps), cfg)
    return x + h


def decode_step(params: L.Params, cache: kvc.KVCache, token: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, kvc.KVCache]:
    """Logits for one new token; token: [B]. The MoE dispatches the B
    tokens of the step together (capacity ``round(1.25 B k / E)``), as the
    reference does. Writes the cache in place and returns it advanced."""
    x = L.embed(params, token[:, None], cfg)
    at = torch.full((1,), cache.pos, device=x.device)
    for i, lp in enumerate(params.layers):
        q, k, v = T.qkv(lp, x, cfg, at)
        out = T.cached_attention(kvc.layer_slices(cache, i), q, k, v,
                                 cache.pos, 0)
        x = _finish_layer(lp, x, out, cfg)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.logits(params, x, cfg)[:, 0], cache._replace(pos=cache.pos + 1)


def prefill(params: L.Params, tokens: torch.Tensor, cfg: ModelConfig,
            capacity: Optional[int] = None, use_flash: bool = False
            ) -> tuple[torch.Tensor, kvc.KVCache]:
    """Process a full prompt, building the KV cache (``capacity`` slots a
    sequence, at least the prompt's length); attention to the fresh K/V,
    as the reference's ``prefill``. With ``use_flash`` each layer's
    attention is one launch of kernel B5 on the card."""
    B, S = tokens.shape
    cache = kvc.make_cache(cfg, cfg.n_layers, B, capacity or S,
                           tokens.device)
    x = L.embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device)
    for i, lp in enumerate(params.layers):
        q, k, v = T.qkv(lp, x, cfg, positions)
        kvc.write(kvc.layer_slices(cache, i), k, v, 0)
        out = L.attend(q, k, v, positions, positions, causal=True,
                       use_flash=use_flash, impl=cfg.attn_impl,
                       block_k=cfg.attn_block_k)
        x = _finish_layer(lp, x, out, cfg)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    lg = L.logits(params, x[:, -1:], cfg)[:, 0]
    return lg, cache._replace(pos=S)
