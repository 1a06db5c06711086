"""Hymba (arXiv:2411.13676): hybrid-head blocks — attention heads and
selective-SSM (mamba-style) heads run *in parallel* on the same input, their
normalized outputs averaged — plus a SwiGLU FFN. The port of
``repro.models.hymba``, for serving.

* the selective SSM (diagonal A per channel, data-dependent delta, B_t,
  C_t and a depthwise causal conv) is evaluated chunkwise in plain torch
  (``ssm_chunked``): within a chunk the (C_i . B_j) Gram matrix is one
  matmul and the per-channel decays fold into an exp-of-cumsum mask; the
  state is carried from chunk to chunk by a Python loop, where the
  reference scans;
* attention uses the sliding window (``cfg.sliding_window``), so it never
  takes the flash route (``layers.attend`` sends no window to B5).

Serving cache = ring KV (window) + SSM state + conv tail, the last two
updated in place with the ring.

``loss_fn`` is the cross-entropy of ``forward``'s logits, as the
reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from . import kv_cache as kvc
from . import layers as L
from . import transformer as T
from .config import ModelConfig

CONV_K = 4  # depthwise causal conv kernel width (mamba standard)


def ssm_init(gen: torch.Generator, cfg: ModelConfig) -> L.Params:
    d = cfg.d_model
    N = cfg.ssm_state or 16
    dev = gen.device
    return L.Params(
        w_in=L.normal(gen, (d, d), d ** -0.5),
        w_x=L.normal(gen, (d, 2 * N + 1), d ** -0.5),
        w_out=L.normal(gen, (d, d), d ** -0.5),
        a_log=torch.zeros(d, device=dev),                 # A = -exp(a_log)
        d_skip=torch.ones(d, device=dev),
        dt_bias=torch.full((1,), -2.0, device=dev),
        conv_w=L.normal(gen, (CONV_K, d), 0.3))


class SSMState(NamedTuple):
    h: torch.Tensor      # [B, d, N] ssm state
    conv: torch.Tensor   # [B, CONV_K-1, d] conv tail


def _causal_conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over T. x: [B,T,d]; w: [K,d]; tail: [B,K-1,d]."""
    T_ = x.shape[1]
    xx = torch.cat([tail.to(x.dtype), x], dim=1)       # [B, T+K-1, d]
    out = torch.zeros_like(x)
    for i in range(CONV_K):
        out = out + xx[:, i:i + T_] * w[i].to(x.dtype)
    return F.silu(out), xx[:, -(CONV_K - 1):].float()


def ssm_chunked(dx, Bm, Cm, w, h0, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked selective scan (per-channel decay).

    dx: [B,T,d] (delta x), Bm/Cm: [B,T,N], w: [B,T,d] decay in (0,1),
    h0: [B,d,N]. Returns (y [B,T,d] in dx's dtype, h_T float32)."""
    B, T_, d = dx.shape
    N = Bm.shape[-1]
    C = min(chunk, T_)
    while T_ % C:  # largest feasible chunk <= requested
        C -= 1
    n = T_ // C

    dxc = dx.reshape(B, n, C, d)
    bc = Bm.reshape(B, n, C, N)
    cc = Cm.reshape(B, n, C, N)
    logw = torch.log(torch.clamp(w.reshape(B, n, C, d).float(), 1e-9, 1.0))
    cum = torch.cumsum(logw, dim=2)  # [B,n,C,d]
    idx = torch.arange(C, device=dx.device)
    incl = idx[:, None] >= idx[None, :]  # j <= i (h_i includes x_i)

    h = h0.float()
    ys = []
    for c in range(n):
        dxf, bf, cf = dxc[:, c].float(), bc[:, c].float(), cc[:, c].float()
        cumb = cum[:, c]                                  # [B,C,d]
        total = cumb[:, -1]                               # [B,d]
        # incoming state: y_in_i[c] = prod_{t<=i} w * (C_i . h0[c,:])
        y = torch.exp(cumb) * torch.einsum("bin,bdn->bid", cf, h)
        # intra-chunk: y_i[c] += sum_{j<=i} exp(cum_i - cum_j)[c] dx_j[c]
        #   (C_i . B_j)
        gram = torch.einsum("bin,bjn->bij", cf, bf)       # [B,C,C]
        diff = cumb[:, :, None] - cumb[:, None, :]        # [B,C(i),C(j),d]
        decay = torch.exp(diff.masked_fill(~incl[None, :, :, None],
                                           float("-inf")))
        y = y + torch.einsum("bij,bijd,bjd->bid", gram, decay, dxf)
        # state carry: h' = exp(total) h + sum_j exp(cum_last - cum_j)
        #   dx_j B_j
        dout = torch.exp(total[:, None] - cumb)           # [B,C,d]
        h = h * torch.exp(total)[:, :, None] + \
            torch.einsum("bjd,bjn->bdn", dxf * dout, bf)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, T_, d)
    return y.to(dx.dtype), h


def _ssm_inputs(p: L.Params, x: torch.Tensor, tail: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, ...]:
    """The input projection and conv, then the scan's inputs: (u, dx, Bm,
    Cm, w, new conv tail), w = exp(delta A) and dx = delta u."""
    N = cfg.ssm_state or 16
    u, new_tail = _causal_conv(x @ p.w_in.to(x.dtype), p.conv_w, tail)
    xproj = u @ p.w_x.to(u.dtype)
    Bm, Cm, dt = xproj[..., :N], xproj[..., N:2 * N], xproj[..., 2 * N:]
    delta = F.softplus(dt.float() + p.dt_bias)                # [B,T,1]
    w = torch.exp(delta * -torch.exp(p.a_log)[None, None])    # [B,T,d]
    return u, delta * u.float(), Bm, Cm, w, new_tail


def ssm_apply(p: L.Params, x: torch.Tensor, st: SSMState, cfg: ModelConfig
              ) -> tuple[torch.Tensor, SSMState]:
    """x: [B,T,d] -> (y, new state)."""
    u, dx, Bm, Cm, w, new_tail = _ssm_inputs(p, x, st.conv, cfg)
    y, h_new = ssm_chunked(dx.to(u.dtype), Bm, Cm, w, st.h, cfg.ssm_chunk)
    y = y + u * p.d_skip.to(u.dtype)
    return y @ p.w_out.to(x.dtype), SSMState(h_new, new_tail)


# ---------------------------------------------------------------------------
# Hybrid block
# ---------------------------------------------------------------------------


def layer_init(gen: torch.Generator, cfg: ModelConfig) -> L.Params:
    d, dev = cfg.d_model, gen.device
    return L.Params(
        in_norm=L.rmsnorm_init(d, dev), attn=L.attention_init(gen, cfg),
        ssm=ssm_init(gen, cfg), attn_out_norm=L.rmsnorm_init(d, dev),
        ssm_out_norm=L.rmsnorm_init(d, dev), mlp_norm=L.rmsnorm_init(d, dev),
        mlp=L.mlp_init(gen, d, cfg.d_ff, cfg.act))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> L.Params:
    """Random float32 master weights from a seeded ``torch.Generator`` on
    ``device`` (the card unless ``device`` says otherwise)."""
    gen = L.generator(device, seed)
    params = L.embedding_init(gen, cfg)
    params.layers = nn.ModuleList(layer_init(gen, cfg)
                                  for _ in range(cfg.n_layers))
    params.final_norm = L.rmsnorm_init(cfg.d_model, gen.device)
    return params


def _fuse(lp: L.Params, x: torch.Tensor, attn_out: torch.Tensor,
          ssm_out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The two heads' normalized mean on the residual, then the MLP."""
    eps = cfg.norm_eps
    x = x + 0.5 * (L.rmsnorm(lp.attn_out_norm, attn_out, eps)
                   + L.rmsnorm(lp.ssm_out_norm, ssm_out, eps))
    return x + L.mlp_apply(lp.mlp, L.rmsnorm(lp.mlp_norm, x, eps), cfg.act)


def layer_apply(lp: L.Params, x: torch.Tensor, st: SSMState,
                cfg: ModelConfig, positions: torch.Tensor, use_flash: bool
                ) -> tuple[torch.Tensor, SSMState]:
    xn = L.rmsnorm(lp.in_norm, x, cfg.norm_eps)
    attn_out = L.attention_apply(lp.attn, xn, cfg, positions, causal=True,
                                 window=cfg.sliding_window,
                                 use_flash=use_flash)
    ssm_out, st_new = ssm_apply(lp.ssm, xn, st, cfg)
    return _fuse(lp, x, attn_out, ssm_out, cfg), st_new


def forward(params: L.Params, tokens: torch.Tensor, cfg: ModelConfig,
            use_flash: bool = False, last_only: bool = False,
            remat: bool = True) -> torch.Tensor:
    B, T_ = tokens.shape
    x = L.embed(params, tokens, cfg)
    positions = torch.arange(T_, device=tokens.device)
    N = cfg.ssm_state or 16
    st = SSMState(torch.zeros(B, cfg.d_model, N, device=tokens.device),
                  torch.zeros(B, CONV_K - 1, cfg.d_model,
                              device=tokens.device))
    apply_one = L.remat(lambda lp, c: layer_apply(lp, c, st, cfg, positions,
                                                  use_flash)[0], remat)
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
# Serving: ring KV (window) + SSM state per layer
# ---------------------------------------------------------------------------


class HymbaCache(NamedTuple):
    kv: kvc.KVCache     # ring caches of capacity = sliding_window
    h: torch.Tensor     # [L, B, d, N]
    conv: torch.Tensor  # [L, B, CONV_K-1, d]


def make_cache(cfg: ModelConfig, batch: int, device) -> HymbaCache:
    cap = cfg.sliding_window or 2048
    N = cfg.ssm_state or 16
    return HymbaCache(
        kvc.make_cache(cfg, cfg.n_layers, batch, cap, device),
        torch.zeros(cfg.n_layers, batch, cfg.d_model, N, device=device),
        torch.zeros(cfg.n_layers, batch, CONV_K - 1, cfg.d_model,
                    device=device))


def _decode_ssm(p: L.Params, x1: torch.Tensor, h: torch.Tensor,
                conv_tail: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token selective scan. x1: [B,1,d]. Returns (out, h, tail)."""
    u, dx, Bm, Cm, w, new_tail = _ssm_inputs(p, x1, conv_tail, cfg)
    h_new = h * w[:, 0, :, None] + dx[:, 0, :, None] * Bm.float()[:, 0, None]
    y = torch.einsum("bdn,bn->bd", h_new, Cm.float()[:, 0])
    y = y[:, None].to(x1.dtype) + u * p.d_skip.to(u.dtype)
    return y @ p.w_out.to(x1.dtype), h_new, new_tail


def decode_step(params: L.Params, cache: HymbaCache, token: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, HymbaCache]:
    """Logits for one new token; token: [B]. Attention over the ring of
    the last ``sliding_window`` positions, the SSM one step on; the cache
    is written in place and returned advanced."""
    x = L.embed(params, token[:, None], cfg)
    pos = cache.kv.pos
    window = cfg.sliding_window or cache.kv.capacity
    at = torch.full((1,), pos, device=x.device)
    for i, lp in enumerate(params.layers):
        xn = L.rmsnorm(lp.in_norm, x, cfg.norm_eps)
        q, k, v = T.rotated_qkv(lp.attn, xn, cfg, at)
        out = T.cached_attention(kvc.layer_slices(cache.kv, i), q, k, v,
                                 pos, window)
        attn_out = out.reshape(*x.shape[:2], -1) @ lp.attn.wo.to(x.dtype)
        ssm_out, h_new, tail = _decode_ssm(lp.ssm, xn, cache.h[i],
                                           cache.conv[i], cfg)
        cache.h[i] = h_new
        cache.conv[i] = tail
        x = _fuse(lp, x, attn_out, ssm_out, cfg)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return (L.logits(params, x, cfg)[:, 0],
            cache._replace(kv=cache.kv._replace(pos=pos + 1)))
