"""tinyllama-1.1b [dense] — 22L d=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
[arXiv:2401.02385; hf]"""
from repro_torch.models.config import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense",
        source="arXiv:2401.02385",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
        d_ff=5632, vocab=32_000,
        supports_decode=True, supports_long_context=False,
    )
