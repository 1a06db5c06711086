"""hymba-1.5b [hybrid] — 32L d=1600 25H (GQA kv=5) d_ff=5504 ssm_state=16,
parallel attention + mamba heads, sliding-window attention.
[arXiv:2411.13676; hf]"""
from repro_torch.models.config import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        source="arXiv:2411.13676",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab=32_001,
        ssm_state=16, ssm_chunk=64, sliding_window=1024,
        supports_decode=True, supports_long_context=True,
    )
