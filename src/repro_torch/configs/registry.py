"""Architecture registry: ``--arch <id>`` -> config and model functions —
the port of ``repro.configs.registry``, for serving.

Every assigned architecture's configuration is selectable. The model
families the port runs are ``dense`` (transformer) and ``ssm`` (rwkv6);
the others raise ``NotImplementedError``.
"""

from __future__ import annotations

import importlib
from typing import Callable, Optional

from repro_torch.models import rwkv6, transformer
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

FAMILY_MODULES = {"dense": transformer, "ssm": rwkv6}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[arch]).config()


def model_module(cfg: ModelConfig):
    if cfg.family not in FAMILY_MODULES:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet "
            f"(ROADMAP Queue A item 10)")
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
    """Uniform prefill step: last-token logits over the whole prompt and
    the decode state after it, through the prefill kernels (B5 for dense,
    whose KV cache gets ``capacity`` slots a sequence; B6 for ssm) on the
    card and their plain versions on the CPU. The dense prefill attends to
    K/V as its cache returns them (``read_back``), as the reference
    ``Server``'s token-at-a-time prefix does; with a KV cache in the
    activations' dtype that is the reference's ``prefill``, which runs
    without its kernels."""
    mod = model_module(cfg)
    if cfg.family == "dense":
        def prefill(params, batch):
            return mod.prefill(params, batch["tokens"], cfg,
                               capacity=capacity, use_flash=True,
                               read_back=True)
        return prefill

    def prefill(params, batch):  # ssm
        return mod.forward(params, batch["tokens"], cfg, use_kernel=True,
                           last_only=True)
    return prefill
