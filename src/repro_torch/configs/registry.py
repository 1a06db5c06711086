"""Architecture registry: ``--arch <id>`` -> config and model functions —
the port of ``repro.configs.registry``, for serving.

Every assigned architecture is selectable, and each of the six model
families maps onto the shared serving API (init_params / decode_step /
a prefill step) plus its family's extra inputs (the vlm's image and the
audio family's frames, from stub frontends).
"""

from __future__ import annotations

import importlib
from typing import Callable, Optional

from repro_torch.models import (hymba, moe, rwkv6, transformer, vlm,
                                whisper)
from repro_torch.models.config import ModelConfig

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
