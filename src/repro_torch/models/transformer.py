"""Dense decoder-only transformer (llama/qwen family) — the port of
``repro.models.transformer``, for serving.

Covers qwen1.5-32b, smollm-360m, tinyllama-1.1b, minitron-8b; the MoE
family swaps the FFN (``moe``), and ``hymba``, ``vlm`` and ``whisper``
reuse its layers and its cached attention. The layers are an
``nn.ModuleList`` walked by a Python loop (the reference scans stacked
parameters); for training the same functions take the reference's
stacked tree through ``layers.bind``.

API (``init_params``, ``forward`` and ``decode_step`` shared by every
family, vlm and whisper taking their image or frames beside the tokens;
``prefill`` shared with moe):
  init_params(cfg, seed, device)            -> the model (a ``Params``)
  forward(params, tokens, cfg, ...)         -> [B, S, V] logits
  loss_fn(params, batch, cfg, ...)          -> scalar loss (float32)
  prefill(params, tokens, cfg, ...)         -> (last-token logits, KVCache)
  decode_step(params, cache, token, cfg)    -> (logits, KVCache)

``forward``'s ``remat`` (default True, as the reference's) recomputes each
layer in the backward pass (``layers.remat``); it changes no value.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import kv_cache as kvc
from . import layers as L
from .config import ModelConfig


def layer_init(gen: torch.Generator, cfg: ModelConfig) -> L.Params:
    return L.Params(
        attn_norm=L.rmsnorm_init(cfg.d_model, gen.device),
        attn=L.attention_init(gen, cfg),
        mlp_norm=L.rmsnorm_init(cfg.d_model, gen.device),
        mlp=L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act))


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
                positions: torch.Tensor, use_flash: bool) -> torch.Tensor:
    h = L.attention_apply(lp.attn, L.rmsnorm(lp.attn_norm, x, cfg.norm_eps),
                          cfg, positions, causal=True,
                          window=cfg.sliding_window, use_flash=use_flash)
    x = x + h
    h = L.mlp_apply(lp.mlp, L.rmsnorm(lp.mlp_norm, x, cfg.norm_eps), cfg.act)
    return x + h


def forward(params: L.Params, tokens: torch.Tensor, cfg: ModelConfig,
            use_flash: bool = False, last_only: bool = False,
            remat: bool = True) -> torch.Tensor:
    x = L.embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    apply_one = L.remat(lambda lp, c: layer_apply(lp, c, cfg, positions,
                                                  use_flash), remat)
    for lp in params.layers:
        x = apply_one(lp, x)
    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.logits(params, x, cfg)


def loss_fn(params: L.Params, batch: dict, cfg: ModelConfig,
            remat: bool = True) -> torch.Tensor:
    lg = forward(params, batch["tokens"], cfg, remat=remat)
    return L.cross_entropy(lg, batch["labels"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def qkv(lp: L.Params, x: torch.Tensor, cfg: ModelConfig,
        positions: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """A layer's rotated q [B, S, H, hd] and k, and v [B, S, KV, hd], from
    its input ``x`` [B, S, d] at ``positions`` [S]."""
    return rotated_qkv(lp.attn, L.rmsnorm(lp.attn_norm, x, cfg.norm_eps),
                       cfg, positions)


def rotated_qkv(a: L.Params, xa: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The attention group ``a``'s rotated q and k, and v, from its
    normalized input ``xa`` [B, S, d]."""
    B, S, _ = xa.shape
    hd = cfg.resolved_head_dim()
    q = L._proj(xa, a.wq, a.get("wq_b")).reshape(B, S, cfg.n_heads, hd)
    k = L._proj(xa, a.wk, a.get("wk_b")).reshape(B, S, cfg.n_kv_heads, hd)
    v = L._proj(xa, a.wv, a.get("wv_b")).reshape(B, S, cfg.n_kv_heads, hd)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def attn_residual(lp: L.Params, x: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """The residual stream after attention: ``x`` plus the heads ``out``
    [B, S, H, hd] through the output projection."""
    B, S = out.shape[:2]
    return x + out.reshape(B, S, -1) @ lp.attn.wo.to(out.dtype)


def _finish_layer(lp: L.Params, x: torch.Tensor, out: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The attention output projection, the residual and the MLP."""
    x = attn_residual(lp, x, out)
    return x + L.mlp_apply(lp.mlp, L.rmsnorm(lp.mlp_norm, x, cfg.norm_eps),
                           cfg.act)


def cached_attention(layer_kv: kvc.LayerKV, q: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor, pos: int,
                     window: int) -> torch.Tensor:
    """One token's attention against a layer's ring cache: writes its k, v
    [B, 1, KV, hd] at ``pos`` (in place) and attends q [B, 1, H, hd] to
    every written slot, or with ``window`` to those holding one of the
    last ``window`` positions. Returns [B, 1, H, hd]."""
    B = q.shape[0]
    kvc.write(layer_kv, k, v, pos)
    k_all, v_all = kvc.read(layer_kv, q.dtype)
    cap = k_all.shape[1]
    slots = torch.arange(cap, device=q.device)
    # absolute position each ring slot currently holds
    ring_pos = torch.where(slots <= pos % cap, slots, slots - cap) \
        + (pos // cap) * cap
    valid = slots < min(pos + 1, cap)
    if window:
        valid &= ring_pos > (pos - window)
    kv_mask = valid[None, :].expand(B, cap)
    at = torch.full((1,), pos, device=q.device)   # no host-to-card copy
    return L.attend(q, k_all, v_all, at, ring_pos, causal=False, window=0,
                    kv_mask=kv_mask)


def _decode_layer(lp: L.Params, layer_kv: kvc.LayerKV, x: torch.Tensor,
                  cfg: ModelConfig, pos: int,
                  window: int) -> tuple[torch.Tensor, kvc.LayerKV]:
    """One token (x: [B, 1, d]) against this layer's cache."""
    q, k, v = qkv(lp, x, cfg, torch.full((1,), pos, device=x.device))
    out = cached_attention(layer_kv, q, k, v, pos, window)
    return _finish_layer(lp, x, out, cfg), layer_kv


def decode_step(params: L.Params, cache: kvc.KVCache, token: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, kvc.KVCache]:
    """Logits for one new token; token: [B]. Writes the token's K/V into
    ``cache`` in place and returns it advanced by one position."""
    x = L.embed(params, token[:, None], cfg)
    for i, lp in enumerate(params.layers):
        x, _ = _decode_layer(lp, kvc.layer_slices(cache, i), x, cfg,
                             cache.pos, cfg.sliding_window)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.logits(params, x, cfg)[:, 0], cache._replace(pos=cache.pos + 1)


def prefill(params: L.Params, tokens: torch.Tensor, cfg: ModelConfig,
            capacity: Optional[int] = None, use_flash: bool = False,
            read_back: bool = False) -> tuple[torch.Tensor, kvc.KVCache]:
    """Process a full prompt, building the KV cache (``capacity`` slots a
    sequence, at least the prompt's length). With ``use_flash`` each layer's
    attention is one launch of kernel B5 on the card.

    With ``read_back`` (the serving prefill) each layer attends to its K/V
    as the cache returns them, ``kvc.read`` of the first S slots in the
    activations' dtype, as the reference ``decode_step`` does token by
    token: an int8 cache is quantized then dequantized, a cache of another
    float dtype is cast. Where the cache holds the activations' dtype the
    read-back is the fresh K/V bit for bit, so they are kept. The default
    is the reference's ``prefill``, which attends to the fresh K/V."""
    B, S = tokens.shape
    cache = kvc.make_cache(cfg, cfg.n_layers, B, capacity or S,
                           tokens.device)
    x = L.embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device)
    for i, lp in enumerate(params.layers):
        q, k, v = qkv(lp, x, cfg, positions)
        layer = kvc.write(kvc.layer_slices(cache, i), k, v, 0)
        if read_back and layer.k.dtype != x.dtype:
            k, v = kvc.read(layer, x.dtype, S)
        out = L.attend(q, k, v, positions, positions, causal=True,
                       window=cfg.sliding_window, use_flash=use_flash,
                       impl=cfg.attn_impl, block_k=cfg.attn_block_k)
        x = _finish_layer(lp, x, out, cfg)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    lg = L.logits(params, x[:, -1:], cfg)[:, 0]
    return lg, cache._replace(pos=S)
