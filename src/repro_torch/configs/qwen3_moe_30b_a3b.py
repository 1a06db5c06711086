"""qwen3-moe-30b-a3b [moe] — 48L d=2048 32H (GQA kv=4) expert_ff=768
vocab=151936, 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.config import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, d_expert=768, vocab=151_936,
        n_experts=128, top_k=8, capacity_factor=1.25,
        rope_theta=1_000_000.0,
        supports_decode=True, supports_long_context=False,
    )
