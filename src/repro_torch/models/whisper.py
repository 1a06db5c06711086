"""whisper-tiny backbone (arXiv:2212.04356): encoder-decoder transformer —
the port of ``repro.models.whisper``, for serving.

The conv frontend is a stub, as in the reference: the caller supplies
precomputed frame embeddings [B, n_frames, d_model] (what the two conv
layers would make of the log-mel spectrogram). Encoder: bidirectional
self-attention + GELU MLP with sinusoidal positions. Decoder: causal
self-attention + cross-attention over the encoder output. Plain LayerNorm,
and sinusoidal positions on both sides, as in the reference.

As in the reference, ``forward`` rotates the self-attention's q and k
(``layers.attention_apply``) and ``decode_step`` does not.

The encoder's self-attention runs kernel B5, non-causal, once a layer
when asked (``use_flash``): the ``Server`` encodes so on the card, where
the reference's ``encode`` runs plain jnp.

``loss_fn`` is the cross-entropy of ``forward``'s logits, with the
frames from the batch (``frames``), as the reference's; ``remat``
recomputes each encoder and decoder layer in the backward pass.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from . import kv_cache as kvc
from . import layers as L
from . import transformer as T
from .config import ModelConfig


@functools.lru_cache(maxsize=8)
def sinusoid(n: int, d: int, device="cpu") -> torch.Tensor:
    """[n, d] float32 positions, computed in float64 on the host as the
    reference does, then kept on ``device`` (once a shape and device: the
    decode step reads one row a token)."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    inv = 1.0 / (10_000 ** (dim / max(d // 2 - 1, 1)))
    ang = pos * inv
    table = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


def enc_layer_init(gen: torch.Generator, cfg: ModelConfig) -> L.Params:
    d, dev = cfg.d_model, gen.device
    return L.Params(attn_norm=L.layernorm_init(d, dev),
                    attn=L.attention_init(gen, cfg),
                    mlp_norm=L.layernorm_init(d, dev),
                    mlp=L.mlp_init(gen, d, cfg.d_ff, "gelu"))


def dec_layer_init(gen: torch.Generator, cfg: ModelConfig) -> L.Params:
    d, dev = cfg.d_model, gen.device
    return L.Params(attn_norm=L.layernorm_init(d, dev),
                    attn=L.attention_init(gen, cfg),
                    xattn_norm=L.layernorm_init(d, dev),
                    xattn=L.attention_init(gen, cfg),
                    mlp_norm=L.layernorm_init(d, dev),
                    mlp=L.mlp_init(gen, d, cfg.d_ff, "gelu"))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> L.Params:
    """Random float32 master weights from a seeded ``torch.Generator`` on
    ``device`` (the card unless ``device`` says otherwise)."""
    gen = L.generator(device, seed)
    params = L.embedding_init(gen, cfg)
    params.enc_layers = nn.ModuleList(enc_layer_init(gen, cfg)
                                      for _ in range(cfg.enc_layers))
    params.dec_layers = nn.ModuleList(dec_layer_init(gen, cfg)
                                      for _ in range(cfg.n_layers))
    params.enc_norm = L.layernorm_init(cfg.d_model, gen.device)
    params.final_norm = L.layernorm_init(cfg.d_model, gen.device)
    return params


def encode(params: L.Params, frames: torch.Tensor, cfg: ModelConfig,
           use_flash: bool = False, remat: bool = True) -> torch.Tensor:
    """frames: [B, T_f, d] precomputed frame embeddings (stub frontend).
    With ``use_flash`` each layer's self-attention is one launch of
    kernel B5, non-causal, on the card."""
    Tf, d = frames.shape[1:]
    x = frames + sinusoid(Tf, d, frames.device)[None].to(frames.dtype)
    positions = torch.arange(Tf, device=frames.device)
    eps = cfg.norm_eps

    def block(lp, x):
        x = x + L.attention_apply(lp.attn, L.layernorm(lp.attn_norm, x, eps),
                                  cfg, positions, causal=False,
                                  use_flash=use_flash)
        return x + L.mlp_apply(lp.mlp, L.layernorm(lp.mlp_norm, x, eps),
                               "gelu")

    block = L.remat(block, remat)
    for lp in params.enc_layers:
        x = block(lp, x)
    return L.layernorm(params.enc_norm, x, eps)


def dec_layer_apply(lp: L.Params, x: torch.Tensor,
                    enc_kv: tuple[torch.Tensor, torch.Tensor],
                    cfg: ModelConfig, positions: torch.Tensor,
                    use_flash: bool) -> torch.Tensor:
    eps = cfg.norm_eps
    x = x + L.attention_apply(lp.attn, L.layernorm(lp.attn_norm, x, eps),
                              cfg, positions, causal=True,
                              use_flash=use_flash)
    x = x + L.attention_apply(lp.xattn, L.layernorm(lp.xattn_norm, x, eps),
                              cfg, positions, causal=False,
                              kv_override=enc_kv)
    return x + L.mlp_apply(lp.mlp, L.layernorm(lp.mlp_norm, x, eps), "gelu")


def _enc_kv(lp: L.Params, enc_out: torch.Tensor, cfg: ModelConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    B, Tf, _ = enc_out.shape
    hd = cfg.resolved_head_dim()
    KV = cfg.n_kv_heads
    a = lp.xattn
    k = L._proj(enc_out, a.wk, a.get("wk_b")).reshape(B, Tf, KV, hd)
    v = L._proj(enc_out, a.wv, a.get("wv_b")).reshape(B, Tf, KV, hd)
    return k, v


def forward(params: L.Params, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, use_flash: bool = False,
            last_only: bool = False, remat: bool = True) -> torch.Tensor:
    enc_out = encode(params, frames, cfg, use_flash, remat)
    S = tokens.shape[1]
    x = L.embed(params, tokens, cfg)
    x = x + sinusoid(S, cfg.d_model, x.device)[None].to(x.dtype)
    positions = torch.arange(S, device=tokens.device)
    block = L.remat(lambda lp, c, e: dec_layer_apply(
        lp, c, _enc_kv(lp, e, cfg), cfg, positions, use_flash), remat)
    for lp in params.dec_layers:
        x = block(lp, x, enc_out)
    if last_only:
        x = x[:, -1:]
    x = L.layernorm(params.final_norm, x, cfg.norm_eps)
    return L.logits(params, x, cfg)


def loss_fn(params: L.Params, batch: dict, cfg: ModelConfig,
            remat: bool = True) -> torch.Tensor:
    lg = forward(params, batch["tokens"], batch["frames"], cfg, remat=remat)
    return L.cross_entropy(lg, batch["labels"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


class WhisperCache(NamedTuple):
    kv: kvc.KVCache     # decoder self-attn caches [L_dec, B, cap, KV, hd]
    ck: torch.Tensor    # [L_dec, B, T_f, KV, hd] cross K (static)
    cv: torch.Tensor    # [L_dec, B, T_f, KV, hd]


def make_cache(cfg: ModelConfig, batch: int, capacity: int,
               device) -> WhisperCache:
    cs = (cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads,
          cfg.resolved_head_dim())
    z = lambda: torch.zeros(cs, dtype=L.dtype_of(cfg), device=device)
    return WhisperCache(kvc.make_cache(cfg, cfg.n_layers, batch, capacity,
                                       device), z(), z())


def build_cross_kv(params: L.Params, enc_out: torch.Tensor, cfg: ModelConfig
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross K/V of every decoder layer, stacked [L_dec, B, T_f, KV, hd]."""
    ks, vs = zip(*(_enc_kv(lp, enc_out, cfg) for lp in params.dec_layers))
    return torch.stack(ks), torch.stack(vs)


def decode_step(params: L.Params, cache: WhisperCache, token: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, WhisperCache]:
    """Logits for one new token; token: [B]. The decoder's position is
    ``sinusoid(capacity)[pos % capacity]``; self-attention runs over the
    ring cache (written in place), cross-attention over the static
    encoder K/V."""
    B = token.shape[0]
    pos, cap = cache.kv.pos, cache.kv.capacity
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    eps = cfg.norm_eps
    x = L.embed(params, token[:, None], cfg)
    x = x + sinusoid(cap, cfg.d_model, x.device)[pos % cap][None, None].to(
        x.dtype)
    at = torch.full((1,), pos, device=x.device)
    k_pos = torch.arange(cache.ck.shape[2], device=x.device)
    for i, lp in enumerate(params.dec_layers):
        a = lp.attn
        xa = L.layernorm(lp.attn_norm, x, eps)
        q = L._proj(xa, a.wq, a.get("wq_b")).reshape(B, 1, H, hd)
        k = L._proj(xa, a.wk, a.get("wk_b")).reshape(B, 1, KV, hd)
        v = L._proj(xa, a.wv, a.get("wv_b")).reshape(B, 1, KV, hd)
        x = T.attn_residual(lp, x, T.cached_attention(
            kvc.layer_slices(cache.kv, i), q, k, v, pos, 0))
        # cross attention over the (static) encoder K/V
        xa = L.layernorm(lp.xattn_norm, x, eps)
        q = L._proj(xa, lp.xattn.wq, lp.xattn.get("wq_b")).reshape(
            B, 1, H, hd)
        out = L.attend(q, cache.ck[i].to(x.dtype), cache.cv[i].to(x.dtype),
                       at, k_pos, causal=False)
        x = x + out.reshape(B, 1, H * hd) @ lp.xattn.wo.to(x.dtype)
        x = x + L.mlp_apply(lp.mlp, L.layernorm(lp.mlp_norm, x, eps), "gelu")
    x = L.layernorm(params.final_norm, x, eps)
    return (L.logits(params, x, cfg)[:, 0],
            cache._replace(kv=cache.kv._replace(pos=pos + 1)))
