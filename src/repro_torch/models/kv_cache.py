"""KV caches for decode: dense (bf16/f32) or int8-quantized, ring-indexed —
the port of ``repro.models.kv_cache``.

Layout: a leading layer dim L, so layer l's slice is ``cache.k[l]``.
Quantization is per (token, kv-head): int8 payload plus an f32 scale.

Unlike the reference, whose arrays are immutable, :func:`write` updates the
layer's slice in place (the cache is the largest state a server holds), so
a cache handed to ``decode_step`` or ``prefill`` is the one they return,
advanced. ``pos`` is a host int: the decode loop computes its ring
positions on the host, without reading the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import ModelConfig


class KVCache(NamedTuple):
    k: torch.Tensor                  # [L, B, S, KV, hd] kv_dtype
    v: torch.Tensor                  # [L, B, S, KV, hd]
    k_scale: Optional[torch.Tensor]  # [L, B, S, KV] f32 (int8 only)
    v_scale: Optional[torch.Tensor]  # [L, B, S, KV] f32
    pos: int                         # number of tokens written

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def make_cache(cfg: ModelConfig, n_layers: int, batch: int, capacity: int,
               device) -> KVCache:
    hd = cfg.resolved_head_dim()
    kv_dt = getattr(torch, cfg.kv_dtype)
    quant = kv_dt == torch.int8
    shape = (n_layers, batch, capacity, cfg.n_kv_heads, hd)
    sshape = shape[:-1]
    scale = (lambda: torch.zeros(sshape, device=device)) if quant \
        else (lambda: None)
    return KVCache(torch.zeros(shape, dtype=kv_dt, device=device),
                   torch.zeros(shape, dtype=kv_dt, device=device),
                   scale(), scale(), 0)


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: x [..., hd] -> (q, scale[...])."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


class LayerKV(NamedTuple):
    """One layer's slice of the cache."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]


def layer_slices(cache: KVCache, layer: int) -> LayerKV:
    """Layer ``layer``'s slice of ``cache``, as views into it."""
    pick = lambda x: None if x is None else x[layer]
    return LayerKV(cache.k[layer], cache.v[layer], pick(cache.k_scale),
                   pick(cache.v_scale))


def write(layer: LayerKV, k_new: torch.Tensor, v_new: torch.Tensor,
          pos: int) -> LayerKV:
    """Insert [B, S_new, KV, hd] at ring position ``pos`` (mod capacity), in
    place. As ``jax.lax.dynamic_update_slice`` does, a start that would run
    past the end moves back so the update fits; an update longer than the
    capacity raises."""
    cap, n = layer.k.shape[1], k_new.shape[1]
    if n > cap:
        raise ValueError(f"KV write of {n} tokens exceeds the cache's "
                         f"capacity {cap}")
    idx = min(pos % cap, cap - n)
    if layer.k.dtype == torch.int8:
        kq, ks = quantize(k_new)
        vq, vs = quantize(v_new)
        layer.k[:, idx:idx + n] = kq
        layer.v[:, idx:idx + n] = vq
        layer.k_scale[:, idx:idx + n] = ks
        layer.v_scale[:, idx:idx + n] = vs
    else:
        layer.k[:, idx:idx + n] = k_new.to(layer.k.dtype)
        layer.v[:, idx:idx + n] = v_new.to(layer.v.dtype)
    return layer


def read(layer: LayerKV, dtype: torch.dtype, n: Optional[int] = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dequantized K/V [B, S, KV, hd] in ``dtype``: the full capacity, or
    with ``n`` only the first ``n`` slots (the serving prefill's)."""
    if n is not None:
        layer = LayerKV(*(None if x is None else x[:, :n] for x in layer))
    if layer.k.dtype == torch.int8:
        return (dequantize(layer.k, layer.k_scale, dtype),
                dequantize(layer.v, layer.v_scale, dtype))
    return layer.k.to(dtype), layer.v.to(dtype)
