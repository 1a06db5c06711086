"""Architecture registry: ``--arch <id>`` -> config and model functions —
the port of ``repro.configs.registry``, for serving and training.

Every assigned architecture is selectable, and each of the six model
families maps onto the shared API (init_params / loss_fn / decode_step /
a prefill step) plus its family's extra inputs (the vlm's image and the
audio family's frames, from stub frontends).

Training takes the parameters in the reference's tree layout
(``layers.stacked``): ``make_loss_fn``'s loss, ``abstract_params`` (meta
tensors) and the exact counts work on that tree. Input specs are meta
tensors; a concrete batch is drawn on an explicit ``torch.Generator``.
``cell_supported`` and ``decode_input_specs`` serve the dry run
(``repro_torch.launch.dryrun``).
"""

from __future__ import annotations

import importlib
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.models import (hymba, kv_cache, moe, rwkv6, transformer,
                                vlm, whisper)
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, ShapeConfig

ARCH_MODULES = {
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "hymba-1.5b": "repro_torch.configs.hymba_1b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

ARCHS = tuple(ARCH_MODULES)

FAMILY_MODULES = {
    "dense": transformer,
    "moe": moe,
    "ssm": rwkv6,
    "hybrid": hymba,
    "vlm": vlm,
    "audio": whisper,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[arch]).config()


def model_module(cfg: ModelConfig):
    return FAMILY_MODULES[cfg.family]


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """The family's model with random weights from ``seed``, on ``device``
    (the card unless ``device`` says otherwise)."""
    return model_module(cfg).init_params(cfg, seed, device)


# ---------------------------------------------------------------------------
# Shape/cell applicability
# ---------------------------------------------------------------------------


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) runnable? Returns (ok, reason-if-not): the
    reference's verdicts and reasons."""
    if shape.kind == "long_decode" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 512k decode requires a "
                       "sub-quadratic/bounded-state path (DESIGN.md "
                       "§Arch-applicability)")
    if shape.kind in ("decode", "long_decode") and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    return True, ""


# ---------------------------------------------------------------------------
# Training: input specs, batches, the loss, abstract parameters
# ---------------------------------------------------------------------------


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """One global training batch as meta tensors (shapes and dtypes)."""
    B, S = shape.global_batch, shape.seq_len
    f = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    batch = {"tokens": f((B, S), torch.int32),
             "labels": f((B, S), torch.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = f((B, cfg.image_tokens, cfg.d_model),
                                  L.dtype_of(cfg))
    if cfg.family == "audio":
        batch["frames"] = f((B, cfg.n_frames, cfg.d_model), L.dtype_of(cfg))
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """``(cache, token)`` of a decode step at ``shape`` as meta tensors,
    the family's cache leaf for leaf the reference's: the KV cache
    (capacity ``seq_len``), rwkv6's stacked state, hymba's ring and SSM
    state, the vlm's and whisper's caches with their cross K/V. The KV
    cache's ``pos`` is a host int (0), where the reference's is an int32
    scalar."""
    B, S = shape.global_batch, shape.seq_len
    token = torch.empty((B,), dtype=torch.int32, device="meta")
    if cfg.family == "ssm":
        return rwkv6.stacked_state(cfg, B, "meta"), token
    if cfg.family == "hybrid":
        return hymba.make_cache(cfg, B, "meta"), token
    if cfg.family == "vlm":
        return vlm.make_cache(cfg, B, S, "meta"), token
    if cfg.family == "audio":
        return whisper.make_cache(cfg, B, S, "meta"), token
    return kv_cache.make_cache(cfg, cfg.n_layers, B, S, "meta"), token


def make_train_batch(gen: torch.Generator, cfg: ModelConfig, batch: int,
                     seq: int) -> dict:
    """A concrete synthetic batch drawn on ``gen`` (on its device): tokens
    and labels uniform over the vocab, and the vlm's image embeddings or
    the audio family's frames standard normal in ``cfg.dtype``."""
    dev = gen.device
    ints = lambda: torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                                 device=dev, dtype=torch.int32)
    out = {"tokens": ints(), "labels": ints()}
    if cfg.family in ("vlm", "audio"):
        n = cfg.image_tokens if cfg.family == "vlm" else cfg.n_frames
        key = "image_embeds" if cfg.family == "vlm" else "frames"
        out[key] = torch.randn((batch, n, cfg.d_model), generator=gen,
                               device=dev, dtype=L.dtype_of(cfg))
    return out


def _maybe_cast(params: dict, cfg: ModelConfig) -> dict:
    if not cfg.cast_params:
        return params
    dt = L.dtype_of(cfg)
    return T.map(lambda x: x.to(dt) if x.is_floating_point() else x, params)


def make_loss_fn(cfg: ModelConfig, use_flash: bool = False,
                 remat: bool = True) -> Callable:
    """``loss(params, batch)``: the family's ``loss_fn`` on the parameter
    tree (``layers.stacked``'s layout, the masters cast to ``cfg.dtype``
    first where ``cfg.cast_params``). The ssm family runs its plain scan
    (``use_kernel=False``), as the reference's; ``use_flash`` raises
    ``ValueError``: kernel B5 has no backward (nor has the JAX package's
    flash kernel, whose gradient fails), so training runs plain
    attention."""
    if use_flash:
        raise ValueError("use_flash=True in a loss: kernel B5 has no "
                         "backward (nor has the JAX package's flash "
                         "kernel), so training runs plain attention")
    mod = model_module(cfg)

    def loss(params, batch):
        return mod.loss_fn(L.bind(_maybe_cast(params, cfg)), batch, cfg,
                           remat=remat)
    return loss


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors: shapes and dtypes, no memory."""
    return L.stacked(init_params(cfg, 0, "meta"))


def _named_leaves(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def exact_param_count(cfg: ModelConfig) -> int:
    """True parameter count of the implementation (from abstract shapes)."""
    return int(sum(x.numel() for x in T.leaves(abstract_params(cfg))))


def exact_active_param_count(cfg: ModelConfig) -> int:
    """Active params per token: MoE counts top_k experts, else everything
    (the reference's rule, on the same leaf paths)."""
    if not cfg.n_experts:
        return exact_param_count(cfg)
    total = 0
    for keys, leaf in _named_leaves(abstract_params(cfg)):
        n = int(np.prod(leaf.shape))
        if "/moe/w" in keys or keys.endswith("w1") and "moe" in keys:
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return total


def make_decode_fn(cfg: ModelConfig) -> Callable:
    mod = model_module(cfg)

    def decode(params, cache, token):
        return mod.decode_step(params, cache, token, cfg)
    return decode


def make_prefill_fn(cfg: ModelConfig, capacity: Optional[int] = None
                    ) -> Callable:
    """Uniform prefill step over ``batch["tokens"]`` (and the vlm's
    ``image_embeds``, the audio family's ``frames``), as the reference's:

    * dense and moe build the KV cache (``capacity`` slots a sequence) and
      return (last-token logits, cache), through kernel B5 once a layer on
      the card. The dense prefill attends to K/V as its cache returns them
      (``read_back``), as the reference ``Server``'s token-at-a-time prefix
      does; with a KV cache in the activations' dtype that is the
      reference's ``prefill``;
    * ssm returns (last-token logits, recurrent state), through kernel B6;
    * hybrid, vlm and audio return the backbone's last-token logits (their
      caches are built by the decode steps).

    On the CPU the kernels' plain versions run."""
    mod = model_module(cfg)
    if cfg.family == "dense":
        def prefill(params, batch):
            return mod.prefill(params, batch["tokens"], cfg,
                               capacity=capacity, use_flash=True,
                               read_back=True)
        return prefill
    if cfg.family == "moe":
        def prefill(params, batch):
            return mod.prefill(params, batch["tokens"], cfg,
                               capacity=capacity, use_flash=True)
        return prefill
    if cfg.family == "ssm":
        def prefill(params, batch):
            return mod.forward(params, batch["tokens"], cfg, use_kernel=True,
                               last_only=True)
        return prefill
    if cfg.family == "vlm":
        def prefill(params, batch):
            return mod.forward(params, batch["tokens"], batch["image_embeds"],
                               cfg, last_only=True)
        return prefill
    if cfg.family == "audio":
        def prefill(params, batch):
            return mod.forward(params, batch["tokens"], batch["frames"], cfg,
                               last_only=True)
        return prefill

    def prefill(params, batch):  # hybrid
        return mod.forward(params, batch["tokens"], cfg, last_only=True)
    return prefill
