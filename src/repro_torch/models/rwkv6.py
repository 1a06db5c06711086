"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free LM with data-dependent
decay linear attention — the port of ``repro.models.rwkv6``, for serving.

Per head (head size N), per token t:

    S_t = diag(w_t) @ S_{t-1} + k_t^T v_t          (state: N x N)
    o_t = r_t @ (diag(u) @ k_t^T v_t + S_{t-1})     (bonus u on current token)

with data-dependent decay w_t = exp(-exp(decay(x_t))) in (0, 1).

``wkv_chunked`` is the reference's chunked plain form (in-chunk tokens as a
masked [C, C] product, the state carried between chunks); a prefill with
``use_kernel`` runs kernel B6 instead, once per layer. Serving carries
O(1) state per layer ((N x N per head) + token-shift vectors).

``loss_fn`` runs the plain chunked form, as the reference's training
does: kernel B6 has no backward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops

from . import layers as L
from .config import ModelConfig


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.ssm_state or 64               # rwkv6 head size (official: 64)
    return cfg.d_model // hd, hd


def time_mix_init(gen: torch.Generator, cfg: ModelConfig) -> L.Params:
    d = cfg.d_model
    H, hd = _heads(cfg)
    s = d ** -0.5
    dev = gen.device
    half = lambda: torch.full((d,), 0.5, device=dev)
    return L.Params(
        wr=L.normal(gen, (d, d), s), wk=L.normal(gen, (d, d), s),
        wv=L.normal(gen, (d, d), s), wg=L.normal(gen, (d, d), s),
        wo=L.normal(gen, (d, d), s),
        decay_w=L.normal(gen, (d,), 0.1) - 4.0,
        bonus_u=torch.zeros((H, hd), device=dev),
        # token-shift interpolation weights (data-independent part of ddlerp)
        mix_r=half(), mix_k=half(), mix_v=half(), mix_g=half(), mix_w=half())


def channel_mix_init(gen: torch.Generator, cfg: ModelConfig) -> L.Params:
    d, ff = cfg.d_model, cfg.d_ff
    return L.Params(w_in=L.normal(gen, (d, ff), d ** -0.5),
                    w_out=L.normal(gen, (ff, d), ff ** -0.5),
                    mix_c=torch.full((d,), 0.5, device=gen.device))


def layer_init(gen: torch.Generator, cfg: ModelConfig) -> L.Params:
    return L.Params(att_norm=L.rmsnorm_init(cfg.d_model, gen.device),
                    rwkv=time_mix_init(gen, cfg),
                    ffn_norm=L.rmsnorm_init(cfg.d_model, gen.device),
                    cmix=channel_mix_init(gen, cfg))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> L.Params:
    """Random float32 master weights from a seeded ``torch.Generator`` on
    ``device`` (the card unless ``device`` says otherwise)."""
    gen = L.generator(device, seed)
    params = L.embedding_init(gen, cfg)
    params.layers = nn.ModuleList(layer_init(gen, cfg)
                                  for _ in range(cfg.n_layers))
    params.final_norm = L.rmsnorm_init(cfg.d_model, gen.device)
    return params


def token_shift(x: torch.Tensor, prev: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shift sequence right by one; ``prev`` is the last token of the
    previous segment ([B, d]). Returns (shifted, new_prev)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1), x[:, -1]


class RWKVState(NamedTuple):
    s: torch.Tensor        # [B, H, hd, hd] wkv state (stacked: [L, ...])
    shift_a: torch.Tensor  # [B, d] token-shift memory (time mix)
    shift_c: torch.Tensor  # [B, d] token-shift memory (channel mix)


def init_state(cfg: ModelConfig, batch: int, device) -> RWKVState:
    H, hd = _heads(cfg)
    return RWKVState(torch.zeros((batch, H, hd, hd), device=device),
                     torch.zeros((batch, cfg.d_model), device=device),
                     torch.zeros((batch, cfg.d_model), device=device))


def stacked_state(cfg: ModelConfig, batch: int, device) -> RWKVState:
    """Per-layer state stack [L, ...] — the 'cache' for serving. Real
    tensors, one slice per layer (the reference broadcasts one state; a
    torch view written in place would alias the layers)."""
    one = init_state(cfg, batch, device)
    return RWKVState(*(x.repeat(cfg.n_layers, *([1] * x.ndim))
                       for x in one))


def wkv_chunked(r, k, v, w, u, s0, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked data-dependent-decay linear attention (the plain form).

    r/k/v: [B, T, H, hd]; w: [B, T, H, hd] decay in (0,1), clipped to
    [1e-9, 1]; u: [H, hd]; s0: [B, H, hd, hd] (k-dim x v-dim). Returns
    (out [B,T,H,hd], s_T)."""
    B, T, H, hd = r.shape
    C = min(chunk, T)
    while T % C:  # largest feasible chunk <= requested
        C -= 1
    split = lambda x: x.reshape(B, T // C, C, H, hd)
    rc, kc, vc = split(r).float(), split(k).float(), split(v).float()
    logw = torch.log(torch.clamp(split(w).float(), 1e-9, 1.0))
    cum = torch.cumsum(logw, dim=2)                    # inclusive cumsum
    iidx = torch.arange(C, device=r.device)
    strict = (iidx[:, None] > iidx[None, :])[None, :, :, None, None]

    s = s0.float()
    outs = []
    for c in range(T // C):
        rf, kf, vf, cumb, logwb = rc[:, c], kc[:, c], vc[:, c], cum[:, c], \
            logw[:, c]
        total = cumb[:, -1]                            # [B, H, hd]
        d_in = torch.exp(cumb - logwb)                 # prod of w before i
        d_out = torch.exp(total[:, None] - cumb)       # prod of w after i
        out = torch.einsum("bchk,bhkv->bchv", rf * d_in, s)
        # intra-chunk pairwise decays, masked inside the exp
        diff = (cumb - logwb)[:, :, None] - cumb[:, None]
        a = torch.exp(diff.masked_fill(~strict, float("-inf")))
        scores = torch.einsum("bihk,bjhk,bijhk->bijh", rf, kf, a)
        out = out + torch.einsum("bijh,bjhv->bihv", scores, vf)
        cur = torch.einsum("bihk,bihk->bih", rf, kf * u[None, None])
        outs.append(out + cur[..., None] * vf)
        s = s * torch.exp(total)[..., None] + \
            torch.einsum("bchk,bchv->bhkv", kf * d_out, vf)
    out = torch.stack(outs, 1).reshape(B, T, H, hd)
    return out.to(r.dtype), s


def time_mix_inputs(p: L.Params, x: torch.Tensor, shift_prev: torch.Tensor,
                    cfg: ModelConfig) -> tuple[torch.Tensor, ...]:
    """The scan's inputs r, k, v [B, T, H, hd] (x's dtype) and w (float32),
    the gate g [B, T, d] and the new token-shift memory, from the time
    mix's input x [B, T, d]."""
    B, T, d = x.shape
    H, hd = _heads(cfg)
    xs, new_prev = token_shift(x, shift_prev.to(x.dtype))

    def mix(name):
        m = getattr(p, f"mix_{name}").to(x.dtype)
        return x * m + xs * (1 - m)

    r = mix("r") @ p.wr.to(x.dtype)
    k = mix("k") @ p.wk.to(x.dtype)
    v = mix("v") @ p.wv.to(x.dtype)
    g = mix("g") @ p.wg.to(x.dtype)
    # data-dependent decay: w_t = exp(-exp(decay_w + f(x_t)))
    w = torch.exp(-torch.exp(p.decay_w[None, None]
                             + 0.1 * mix("w").float()))
    heads = lambda y: y.reshape(B, T, H, hd)
    return heads(r), heads(k), heads(v), heads(w), g, new_prev


def time_mix_apply(p: L.Params, x: torch.Tensor, state_s: torch.Tensor,
                   shift_prev: torch.Tensor, cfg: ModelConfig,
                   use_kernel: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, T, d] -> (out, new_state, new_shift_prev). With
    ``use_kernel`` and T > 1 the scan is one launch of kernel B6 on the
    card (``ops.rwkv6_scan``)."""
    B, T, d = x.shape
    rh, kh, vh, wh, g, new_prev = time_mix_inputs(p, x, shift_prev, cfg)
    if use_kernel and T > 1:
        out, s_new = kops.rwkv6_scan(rh, kh, vh, wh, p.bonus_u, state_s)
    else:
        out, s_new = wkv_chunked(rh, kh, vh, wh, p.bonus_u, state_s,
                                 chunk=cfg.ssm_chunk if T > 1 else 1)
    out = out.reshape(B, T, d) * F.silu(g)
    return out @ p.wo.to(x.dtype), s_new, new_prev


def channel_mix_apply(p: L.Params, x: torch.Tensor, shift_prev: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    xs, new_prev = token_shift(x, shift_prev.to(x.dtype))
    m = p.mix_c.to(x.dtype)
    h = torch.square(torch.relu((x * m + xs * (1 - m)) @ p.w_in.to(x.dtype)))
    return h @ p.w_out.to(x.dtype), new_prev


def layer_apply(lp: L.Params, x: torch.Tensor, st: RWKVState,
                cfg: ModelConfig,
                use_kernel: bool) -> tuple[torch.Tensor, RWKVState]:
    h, s_new, sa = time_mix_apply(
        lp.rwkv, L.rmsnorm(lp.att_norm, x, cfg.norm_eps), st.s, st.shift_a,
        cfg, use_kernel)
    x = x + h
    h, sc = channel_mix_apply(lp.cmix, L.rmsnorm(lp.ffn_norm, x, cfg.norm_eps),
                              st.shift_c)
    return x + h, RWKVState(s_new, sa, sc)


def _stack(params: L.Params, x: torch.Tensor, state: RWKVState,
           cfg: ModelConfig, use_kernel: bool,
           remat: bool = False) -> tuple[torch.Tensor, RWKVState]:
    """Every layer over x with its slice of the stacked ``state``; returns
    x and the new stacked state."""
    apply_one = L.remat(lambda lp, c, st: layer_apply(lp, c, st, cfg,
                                                      use_kernel), remat)
    new = []
    for i, lp in enumerate(params.layers):
        x, st = apply_one(lp, x, RWKVState(*(y[i] for y in state)))
        new.append(st)
    return x, RWKVState(*(torch.stack(ys) for ys in zip(*new)))


def forward(params: L.Params, tokens: torch.Tensor, cfg: ModelConfig,
            use_kernel: bool = False, state0: RWKVState | None = None,
            last_only: bool = False, remat: bool = True
            ) -> tuple[torch.Tensor, RWKVState]:
    """Logits over ``tokens`` [B, T] from the stacked state ``state0``
    (zeros by default) and the stacked state after them."""
    x = L.embed(params, tokens, cfg)
    if state0 is None:
        state0 = stacked_state(cfg, tokens.shape[0], tokens.device)
    x, state = _stack(params, x, state0, cfg, use_kernel, remat)
    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.logits(params, x, cfg), state


def loss_fn(params: L.Params, batch: dict, cfg: ModelConfig,
            remat: bool = True) -> torch.Tensor:
    lg, _ = forward(params, batch["tokens"], cfg, remat=remat)
    return L.cross_entropy(lg, batch["labels"])


def decode_step(params: L.Params, state: RWKVState, token: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, RWKVState]:
    """One-token step: the recurrence in its O(1) form. state is stacked
    [L, ...]."""
    x = L.embed(params, token[:, None], cfg)
    x, state = _stack(params, x, state, cfg, False)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.logits(params, x, cfg)[:, 0], state
