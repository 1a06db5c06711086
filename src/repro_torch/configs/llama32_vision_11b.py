"""llama-3.2-vision-11b [vlm] — 40L d=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, gated cross-attn every 5th layer; patch-embedding frontend is
a stub. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.models.config import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        source="hf:meta-llama/Llama-3.2-11B-Vision",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14_336, vocab=128_256,
        cross_attn_every=5, image_tokens=1601, rope_theta=500_000.0,
        supports_decode=True, supports_long_context=False,
    )
