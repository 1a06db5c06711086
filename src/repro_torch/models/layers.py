"""Transformer building blocks: norms, RoPE, GQA attention, MLPs, embeddings
— the port of ``repro.models.layers``.

Parameters are float32 masters held in :class:`Params` modules (the
reference's parameter dicts, entry for entry; a model's layers are an
``nn.ModuleList`` where the reference stacks them on a leading ``[L]``),
cast to the activation dtype at each use. Sharding annotations
(``Rules.act``) are the identity on one card and are left out.

Attention runs kernel B5 for a prefill when asked (``use_flash``); the
plain paths (naive and chunked) are its oracle.

Training holds the parameters in the reference's own layout instead: a
tree of dicts whose layer stacks (``STACKS``) are single tensors with the
layers on leading dims. :func:`stacked` makes that tree from a model,
:func:`bind` views it as a model the families' functions take (plain
tensors, so autograd reaches the stacked leaves), and :func:`remat`
recomputes a layer in the backward pass, as ``jax.checkpoint`` does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.utils.checkpoint
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

from .config import ModelConfig

NEG = torch.finfo(torch.float32).min   # the reference's mask fill, not -inf


class Params(nn.Module):
    """A named group of parameters (float32 masters, no gradient) and
    sub-groups: the port of one of the reference's parameter dicts."""

    def __init__(self, /, **entries):     # an entry may be named "self"
        super().__init__()
        for name, x in entries.items():
            if isinstance(x, nn.Module):
                self.add_module(name, x)
            else:
                self.register_parameter(
                    name, nn.Parameter(x, requires_grad=False))

    def get(self, name: str):
        """The entry ``name``, or None where the group has none (the
        reference's ``params.get``)."""
        return getattr(self, name, None)


class View(dict):
    """A parameter group bound for training: the reference's dict, its
    entries plain tensors (or groups, or lists of groups where the
    reference stacks layers) read as attributes, as a :class:`Params`
    module's are."""

    __slots__ = ()

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


# the layer stacks of each family's parameter tree: path -> stacked dims
STACKS = {("layers",): 1, ("enc_layers",): 1, ("dec_layers",): 1,
          ("groups", "self"): 2, ("groups", "cross"): 1}


def stacked(params: nn.Module) -> dict:
    """The model's parameters in the reference's tree layout: a dict a
    group, each ``nn.ModuleList`` stack one tensor a leaf with the layers
    on its leading dim (``torch.stack``, so the tree owns new memory for
    the stacks; the other leaves are the model's tensors, detached)."""
    if isinstance(params, nn.ModuleList):
        kids = [stacked(m) for m in params]

        def stack(*nodes):
            if isinstance(nodes[0], dict):
                return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
            return torch.stack(nodes)
        return stack(*kids)
    out = {k: v.detach() for k, v in params._parameters.items()}
    out.update((k, stacked(m)) for k, m in params._modules.items())
    return out


def _split(node, n: int) -> list:
    """The n slices of a subtree along its leaves' leading dim."""
    if isinstance(node, dict):
        parts = [{} for _ in range(n)]
        for k, v in node.items():
            for part, x in zip(parts, _split(v, n)):
                part[k] = x
        return parts
    return list(node.unbind(0))


def _length(node) -> int:
    while isinstance(node, dict):
        if not node:
            return 0
        node = next(iter(node.values()))
    return node.shape[0]


def bind(tree: dict, path: tuple = ()) -> View:
    """The tree (:func:`stacked`'s layout, leaves plain tensors) as a model
    for the families' functions: each stack a list of :class:`View` (a
    list of lists for the vlm's ``groups.self``), its entries the stacked
    leaves' slices (``unbind``, so the gradient of every layer's slice
    lands in its stacked leaf)."""
    out = View()
    for k, v in tree.items():
        p = path + (k,)
        if p in STACKS:
            out[k] = _unstack(v, STACKS[p])
        elif isinstance(v, dict):
            out[k] = bind(v, p)
        else:
            out[k] = v
    return out


def _unstack(node, depth: int) -> list:
    parts = _split(node, _length(node))
    if depth > 1:
        return [_unstack(p, depth - 1) for p in parts]
    return [bind(p) for p in parts]


def _needs_grad(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.requires_grad
    if isinstance(x, nn.Module):
        return any(p.requires_grad for p in x.parameters())
    if isinstance(x, dict):
        return any(_needs_grad(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_needs_grad(v) for v in x)
    return False


def remat(fn: Callable, enabled: bool) -> Callable:
    """``fn``, its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) when ``enabled`` and a call
    has an argument that autograd records (training); else ``fn`` itself,
    so serving, whose parameters and activations need no gradient, runs
    the layer directly. Values are the same either way."""
    if not enabled:
        return fn

    def run(*args):
        if not (torch.is_grad_enabled() and _needs_grad(args)):
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return run


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class _MetaGen:
    """Stands in for a generator on the meta device (shapes, no values)."""

    device = torch.device("meta")


def generator(device, seed: int):
    """A seeded ``torch.Generator`` on ``device`` (the card unless it says
    otherwise); on the meta device a stand-in, so a model builds as shapes
    alone."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return _MetaGen()
    return torch.Generator(device=dev).manual_seed(seed)


def normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """Seeded float32 normals times ``scale``, drawn on ``gen``'s device."""
    if gen.device.type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device) * scale


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device) -> Params:
    return Params(norm_scale=torch.ones(d, device=device))


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p.norm_scale).to(x.dtype)


def layernorm_init(d: int, device) -> Params:
    return Params(norm_scale=torch.ones(d, device=device),
                  norm_bias=torch.zeros(d, device=device))


def layernorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * p.norm_scale + p.norm_bias
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable). Rotates the
    two halves of the head dim (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs       # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]               # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal / bidirectional / sliding-window / cross)
# ---------------------------------------------------------------------------


def attention_init(gen: torch.Generator, cfg: ModelConfig,
                   d_in: int | None = None) -> Params:
    d = d_in or cfg.d_model
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    s = d ** -0.5
    p = dict(wq=normal(gen, (d, H * hd), s), wk=normal(gen, (d, KV * hd), s),
             wv=normal(gen, (d, KV * hd), s), wo=normal(gen, (H * hd, d), s))
    if cfg.qkv_bias:
        dev = gen.device
        p.update(wq_b=torch.zeros(H * hd, device=dev),
                 wk_b=torch.zeros(KV * hd, device=dev),
                 wv_b=torch.zeros(KV * hd, device=dev))
    return Params(**p)


def _proj(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def mask_logits(logits: torch.Tensor, q_pos: torch.Tensor,
                k_pos: torch.Tensor, causal: bool,
                window: int) -> torch.Tensor:
    """logits: [B, H, Sq, Sk]; q_pos/k_pos: [Sq]/[Sk] absolute positions."""
    ok = torch.ones(logits.shape[-2:], dtype=torch.bool,
                    device=logits.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return logits.masked_fill(~ok, NEG)


def attend_chunked(q, k, v, q_pos, k_pos, causal: bool, window: int,
                   block_k: int) -> torch.Tensor:
    """Online-softmax attention streaming K/V blocks (flash-style memory:
    O(Sq * block_k) live scores), plain torch. q: [B,Sq,H,hd]; k/v:
    [B,Sk,KV,hd]."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    bk = min(block_k, Sk)
    while Sk % bk:
        bk //= 2

    qh = q.reshape(B, Sq, KV, group, hd).float() * (hd ** -0.5)
    m = torch.full((B, KV, group, Sq), NEG, device=q.device)
    l = torch.zeros((B, KV, group, Sq), device=q.device)
    acc = torch.zeros((B, KV, group, Sq, hd), device=q.device)
    for j0 in range(0, Sk, bk):
        kp = k_pos[j0:j0 + bk]
        s = torch.einsum("bqkgh,bskh->bkgqs", qh, k[:, j0:j0 + bk].float())
        ok = torch.ones((Sq, bk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kp[None, :] <= q_pos[:, None]
        if window:
            ok &= kp[None, :] > (q_pos[:, None] - window)
        s = s.masked_fill(~ok, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p, v[:, j0:j0 + bk].float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def attend(q, k, v, q_pos, k_pos, causal: bool = True, window: int = 0,
           kv_mask: Optional[torch.Tensor] = None, use_flash: bool = False,
           impl: str = "naive", block_k: int = 512) -> torch.Tensor:
    """Grouped-query attention.

    q: [B, Sq, H, hd]; k/v: [B, Sk, KV, hd]. Returns [B, Sq, H, hd].
    ``use_flash`` sends a full-sequence self-attention (Sq > 1, no
    ``kv_mask``, no window) to kernel B5 through ``ops.flash_attention``.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV

    if use_flash and Sq > 1 and kv_mask is None and not window:
        return kops.flash_attention(q, k, v, causal=causal)

    if impl == "chunked" and Sq > 1 and kv_mask is None:
        return attend_chunked(q, k, v, q_pos, k_pos, causal, window, block_k)

    qh = q.reshape(B, Sq, KV, group, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qh, k).float()
    logits = logits * (hd ** -0.5)
    logits = logits.reshape(B, KV * group, Sq, k.shape[1])
    logits = mask_logits(logits, q_pos, k_pos, causal, window)
    if kv_mask is not None:  # [B, Sk] validity (e.g. decode cache occupancy)
        logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    probs = probs.reshape(B, KV, group, Sq, k.shape[1])
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def attention_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, causal: bool = True,
                    window: int = 0, use_flash: bool = False,
                    kv_override: Optional[tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention, or cross-attention when ``kv_override`` supplies
    K/V [B, Sk, KV, hd] already projected from the source states: then
    neither side is rotated, the keys sit at ``arange(Sk)`` and the flash
    route is never taken."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = _proj(x, p.wq, p.get("wq_b")).reshape(B, S, H, hd)
    if kv_override is None:
        k = _proj(x, p.wk, p.get("wk_b")).reshape(B, S, KV, hd)
        v = _proj(x, p.wv, p.get("wv_b")).reshape(B, S, KV, hd)
        k_pos = positions
        k = apply_rope(k, k_pos, cfg.rope_theta)
        q = apply_rope(q, positions, cfg.rope_theta)
    else:
        k, v = kv_override
        k_pos = torch.arange(k.shape[1], device=x.device)
    out = attend(q, k, v, positions, k_pos, causal=causal, window=window,
                 kv_mask=kv_mask,
                 use_flash=use_flash and kv_override is None,
                 impl=cfg.attn_impl, block_k=cfg.attn_block_k)
    return out.reshape(B, S, H * hd) @ p.wo.to(out.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, ff: int, act: str) -> Params:
    s_in, s_out = d ** -0.5, ff ** -0.5
    p = dict(w1=normal(gen, (d, ff), s_in), w2=normal(gen, (ff, d), s_out))
    if act == "silu":
        p["w3"] = normal(gen, (d, ff), s_in)
    return Params(**p)


def mlp_apply(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p.w1.to(x.dtype)
    if act == "silu":
        h = F.silu(h) * (x @ p.w3.to(x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ p.w2.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------


def embedding_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The model's top-level group: the token embedding and, untied, the
    output head. The model adds ``layers`` and ``final_norm``."""
    vp = cfg.padded_vocab()
    p = dict(embed=Params(tokens=normal(gen, (vp, cfg.d_model), 0.02)))
    if not cfg.tie_embeddings:
        p["lm_head"] = normal(gen, (cfg.d_model, vp), cfg.d_model ** -0.5)
    return Params(**p)


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-gather
    return p.embed.tokens[tokens].to(dtype_of(cfg))


def logits(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = p.embed.tokens.to(x.dtype).T
    else:
        w = p.lm_head.to(x.dtype)
    out = x @ w
    vp = out.shape[-1]
    if vp != cfg.vocab:  # mask padded vocab tail (never predicted/summed)
        tail = torch.arange(vp, device=out.device) >= cfg.vocab
        # the fill cast to the logits' dtype, as the reference casts it:
        # float32's min rounds to -inf in bfloat16
        out = out.masked_fill(tail, torch.tensor(NEG).to(out.dtype).item())
    return out


def cross_entropy(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32."""
    lg = lg.float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.take_along_dim(lg, labels[..., None].long(), dim=-1)[..., 0]
    return (logz - gold).mean()
