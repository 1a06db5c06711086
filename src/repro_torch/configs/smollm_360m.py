"""smollm-360m [dense] — 32L d=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
[hf:HuggingFaceTB/SmolLM-360M; hf]"""
from repro_torch.models.config import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        source="hf:HuggingFaceTB/SmolLM-360M",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
        d_ff=2560, vocab=49_152, tie_embeddings=True,
        supports_decode=True, supports_long_context=False,
    )
