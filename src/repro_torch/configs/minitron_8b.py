"""minitron-8b [dense] — 32L d=4096 32H (GQA kv=8) d_ff=16384 vocab=256000,
pruned nemotron. [arXiv:2407.14679; hf]"""
from repro_torch.models.config import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b", family="dense",
        source="arXiv:2407.14679",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=16_384, vocab=256_000,
        supports_decode=True, supports_long_context=False,
    )
