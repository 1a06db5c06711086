# The port of repro.models, for serving and training:
#   config.py      — ModelConfig, ShapeConfig, parameter counts
#   layers.py      — norms, RoPE, GQA and cross attention (kernel B5 for a
#                    prefill), MLPs, embeddings, cross_entropy; Params, the
#                    parameter group module; the stacked training layout
#                    (stacked, bind, View) and remat
#   kv_cache.py    — ring KV caches, bf16/f32 or int8
#   transformer.py — the dense family: forward, loss_fn, prefill,
#                    decode_step
#   moe.py         — the moe family: sort-based dispatch, MoEStats
#   rwkv6.py       — the ssm family (kernel B6 for a prefill)
#   hymba.py       — the hybrid family: attention + selective-SSM heads
#   vlm.py         — the vlm family: gated cross-attention groups
#   whisper.py     — the audio family: encoder (B5, non-causal) + decoder
# Every family has its loss_fn; none runs a kernel (B5 and B6 have no
# backward).
from . import config, hymba, kv_cache, layers, moe, rwkv6, transformer, vlm
from . import whisper
from .config import SHAPES, ModelConfig, ShapeConfig
