"""Model configuration schema shared by all ten assigned architectures (the
port's own copy of ``repro.models.config``, field for field)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"   # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""        # provenance tag from the assignment table

    # transformer backbone
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 0       # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab: int = 512
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "silu"       # silu (SwiGLU) | gelu (plain MLP, whisper)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0       # expert FFN width (d_ff used if 0)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_every: int = 1      # MoE layer cadence (1 = every layer)
    moe_block_dispatch: bool = False  # per-sequence dispatch (see moe.py)
    moe_a2a: bool = False   # explicit all-to-all expert parallelism via
                            # shard_map (tokens move, not expert blocks)

    # SSM (rwkv6 / hymba)
    ssm_state: int = 0      # state size per head (rwkv: head_dim; hymba: 16)
    ssm_heads: int = 0
    ssm_chunk: int = 64     # chunked-scan chunk length

    # hybrid attention
    sliding_window: int = 0          # 0 = full attention
    global_attn_layers: tuple = ()   # layer indices with full attention

    # vlm
    cross_attn_every: int = 0   # insert a cross-attn layer after every k layers
    image_tokens: int = 0       # patch-embedding count from the stub frontend

    # audio (enc-dec)
    enc_layers: int = 0
    n_frames: int = 0           # precomputed frame embeddings from the stub

    # attention implementation: 'naive' materializes [Sq, Sk] scores
    # (the baseline); 'chunked' streams K/V blocks with online softmax
    # (flash-style memory footprint, pure jnp, lowers on any backend)
    attn_impl: str = "naive"
    attn_block_k: int = 512

    # training/serving dtypes
    cast_params: bool = False   # cast f32 masters to `dtype` at the loss
                                # boundary (mixed precision: bf16 compute,
                                # f32 master + moments, grads accumulate f32
                                # through the cast)
    dtype: str = "bfloat16"
    kv_dtype: str = "bfloat16"  # int8 supported for decode cells

    # shape-capability flags
    supports_decode: bool = True
    supports_long_context: bool = False  # sub-quadratic path exists

    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def padded_vocab(self) -> int:
        """Physical vocab rounded up to 256 so the vocab dim shards over any
        mesh axis (hymba's 32001 / whisper's 51865 are odd); logits beyond
        the logical vocab are masked to -inf in layers.logits()."""
        return ((self.vocab + 255) // 256) * 256

    def ffn_width(self) -> int:
        return self.d_expert or self.d_ff

    def reduced(self) -> "ModelConfig":
        """The smoke-test configuration: same family/topology, tiny sizes."""
        return dataclasses.replace(
            self,
            n_layers=4 if self.cross_attn_every else 2,
            d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=16,
            d_ff=128, d_expert=96 if self.n_experts else 0,
            vocab=128,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            ssm_chunk=8,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            global_attn_layers=tuple(i for i in self.global_attn_layers if i < 2),
            cross_attn_every=min(self.cross_attn_every, 2) if self.cross_attn_every else 0,
            image_tokens=min(self.image_tokens, 8) if self.image_tokens else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            n_frames=min(self.n_frames, 16) if self.n_frames else 0,
            dtype="float32", kv_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode" | "long_decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}


def param_count(cfg: ModelConfig) -> int:
    """Approximate parameter count (embeddings + backbone)."""
    hd = cfg.resolved_head_dim()
    d = cfg.d_model
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    if cfg.family == "ssm":
        attn = 2 * d * d + d * cfg.d_ff  # rwkv time-mix approximation
    if cfg.n_experts:
        ffw = cfg.ffn_width()
        ffn = cfg.n_experts * 3 * d * ffw + d * cfg.n_experts
    else:
        ffn = 3 * d * cfg.d_ff if cfg.act == "silu" else 2 * d * cfg.d_ff
    per_layer = attn + ffn + 2 * d
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    total = cfg.n_layers * per_layer + emb
    if cfg.enc_layers:
        total += cfg.enc_layers * per_layer
    if cfg.cross_attn_every:
        n_cross = cfg.n_layers // cfg.cross_attn_every
        total += n_cross * (attn + 2 * d)
    return int(total)


def active_param_count(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE uses top_k of n_experts)."""
    if not cfg.n_experts:
        return param_count(cfg)
    hd = cfg.resolved_head_dim()
    d = cfg.d_model
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    ffw = cfg.ffn_width()
    ffn = cfg.top_k * 3 * d * ffw + d * cfg.n_experts
    per_layer = attn + ffn + 2 * d
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return int(cfg.n_layers * per_layer + emb)
