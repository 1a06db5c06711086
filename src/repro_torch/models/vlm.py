"""llama-3.2-vision-11b backbone: a llama decoder with gated cross-attention
layers interleaved every ``cross_attn_every`` layers (8 cross layers among 40
total, as in the released model) — the port of ``repro.models.vlm``, for
serving.

The vision frontend is a stub, as in the reference: the caller supplies
precomputed patch embeddings [B, image_tokens, d_model], the K/V source of
the cross-attention layers.

The layers come in G groups, each (cross_attn_every - 1) dense self layers
(``groups.self[g]``) and one gated cross layer (``groups.cross[g]``),
walked by Python loops where the reference scans the group stack.

``loss_fn`` is the cross-entropy of ``forward``'s logits, with the
image embeddings from the batch (``image_embeds``), as the reference's;
``remat`` recomputes each self layer in the backward pass, as the
reference's does (its cross layers are not rematerialized).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from . import kv_cache as kvc
from . import layers as L
from . import transformer as T
from .config import ModelConfig


def n_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(number of groups, self layers per group)."""
    k = cfg.cross_attn_every
    assert k >= 2 and cfg.n_layers % k == 0, (cfg.n_layers, k)
    return cfg.n_layers // k, k - 1


def cross_layer_init(gen: torch.Generator, cfg: ModelConfig) -> L.Params:
    dev = gen.device
    return L.Params(
        q_norm=L.rmsnorm_init(cfg.d_model, dev),
        attn=L.attention_init(gen, cfg),
        gate_attn=torch.zeros((), device=dev),   # tanh-gated (init 0: no-op)
        kv_norm=L.rmsnorm_init(cfg.d_model, dev))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> L.Params:
    """Random float32 master weights from a seeded ``torch.Generator`` on
    ``device`` (the card unless ``device`` says otherwise)."""
    G, S = n_groups(cfg)
    gen = L.generator(device, seed)
    params = L.embedding_init(gen, cfg)
    params.groups = L.Params(
        self=nn.ModuleList(
            nn.ModuleList(T.layer_init(gen, cfg) for _ in range(S))
            for _ in range(G)),
        cross=nn.ModuleList(cross_layer_init(gen, cfg) for _ in range(G)))
    params.final_norm = L.rmsnorm_init(cfg.d_model, gen.device)
    return params


def _cross_kv(cp: L.Params, img: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    B, M, _ = img.shape
    hd = cfg.resolved_head_dim()
    KV = cfg.n_kv_heads
    xin = L.rmsnorm(cp.kv_norm, img, cfg.norm_eps)
    a = cp.attn
    k = L._proj(xin, a.wk, a.get("wk_b")).reshape(B, M, KV, hd)
    v = L._proj(xin, a.wv, a.get("wv_b")).reshape(B, M, KV, hd)
    return k, v


def cross_apply(cp: L.Params, x: torch.Tensor,
                kv: tuple[torch.Tensor, torch.Tensor],
                cfg: ModelConfig) -> torch.Tensor:
    """The gated cross layer: x attends (unmasked, unrotated) to the image
    K/V ``kv``; the output enters the residual times tanh(gate_attn)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    xq = L.rmsnorm(cp.q_norm, x, cfg.norm_eps)
    q = L._proj(xq, cp.attn.wq, cp.attn.get("wq_b")).reshape(
        B, S, cfg.n_heads, hd)
    k, v = kv
    out = L.attend(q, k.to(x.dtype), v.to(x.dtype),
                   torch.arange(S, device=x.device),
                   torch.arange(k.shape[1], device=x.device), causal=False)
    out = out.reshape(B, S, -1) @ cp.attn.wo.to(x.dtype)
    return x + torch.tanh(cp.gate_attn).to(x.dtype) * out


def forward(params: L.Params, tokens: torch.Tensor,
            image_embeds: torch.Tensor, cfg: ModelConfig,
            use_flash: bool = False, last_only: bool = False,
            remat: bool = True) -> torch.Tensor:
    x = L.embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    self_one = L.remat(lambda lp, c: T.layer_apply(lp, c, cfg, positions,
                                                   use_flash), remat)
    for self_layers, cp in zip(params.groups.self, params.groups.cross):
        for lp in self_layers:
            x = self_one(lp, x)
        x = cross_apply(cp, x, _cross_kv(cp, image_embeds, cfg), cfg)
    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.logits(params, x, cfg)


def loss_fn(params: L.Params, batch: dict, cfg: ModelConfig,
            remat: bool = True) -> torch.Tensor:
    lg = forward(params, batch["tokens"], batch["image_embeds"], cfg,
                 remat=remat)
    return L.cross_entropy(lg, batch["labels"])


# ---------------------------------------------------------------------------
# Serving: self KV caches per self layer + precomputed cross K/V per group
# ---------------------------------------------------------------------------


class VLMCache(NamedTuple):
    kv: kvc.KVCache     # [G*S_layers, B, cap, KV, hd] self-attention caches
    ck: torch.Tensor    # [G, B, M, KV, hd] cross keys (static during decode)
    cv: torch.Tensor    # [G, B, M, KV, hd]


def make_cache(cfg: ModelConfig, batch: int, capacity: int,
               device) -> VLMCache:
    G, S = n_groups(cfg)
    cshape = (G, batch, cfg.image_tokens, cfg.n_kv_heads,
              cfg.resolved_head_dim())
    z = lambda: torch.zeros(cshape, dtype=L.dtype_of(cfg), device=device)
    return VLMCache(kvc.make_cache(cfg, G * S, batch, capacity, device), z(),
                    z())


def build_cross_kv(params: L.Params, image_embeds: torch.Tensor,
                   cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross K/V of every group, stacked [G, B, M, KV, hd]."""
    ks, vs = zip(*(_cross_kv(cp, image_embeds, cfg)
                   for cp in params.groups.cross))
    return torch.stack(ks), torch.stack(vs)


def decode_step(params: L.Params, cache: VLMCache, token: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, VLMCache]:
    """Logits for one new token; token: [B]. Self layer s of group g owns
    slice g S + s of the self-attention caches, written in place."""
    _, S = n_groups(cfg)
    x = L.embed(params, token[:, None], cfg)
    pos = cache.kv.pos
    for g, (self_layers, cp) in enumerate(zip(params.groups.self,
                                              params.groups.cross)):
        for s, lp in enumerate(self_layers):
            x, _ = T._decode_layer(lp, kvc.layer_slices(cache.kv, g * S + s),
                                   x, cfg, pos, 0)
        x = cross_apply(cp, x, (cache.ck[g], cache.cv[g]), cfg)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return (L.logits(params, x, cfg)[:, 0],
            cache._replace(kv=cache.kv._replace(pos=pos + 1)))
