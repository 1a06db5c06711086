"""olmoe-1b-7b [moe] — 16L d=2048 16H (kv=16) expert_ff=1024 vocab=50304,
64 experts top-8. [arXiv:2409.02060; hf]"""
from repro_torch.models.config import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        source="arXiv:2409.02060",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1024, d_expert=1024, vocab=50_304,
        n_experts=64, top_k=8, capacity_factor=1.25,
        supports_decode=True, supports_long_context=False,
    )
