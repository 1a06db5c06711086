# The port of repro.models, for serving:
#   config.py      — ModelConfig, ShapeConfig, parameter counts
#   layers.py      — norms, RoPE, GQA attention (kernel B5 for a prefill),
#                    MLPs, embeddings; Params, the parameter group module
#   kv_cache.py    — ring KV caches, bf16/f32 or int8
#   transformer.py — the dense family: forward, prefill, decode_step
#   rwkv6.py       — the ssm family (kernel B6 for a prefill)
# moe, hymba, vlm and whisper, and every loss_fn, are ROADMAP Queue A
# item 10.
from . import config, kv_cache, layers, rwkv6, transformer
from .config import SHAPES, ModelConfig, ShapeConfig
