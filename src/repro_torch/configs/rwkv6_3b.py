"""rwkv6-3b "Finch" [ssm] — 32L d=2560 (attention-free) d_ff=8960
vocab=65536, data-dependent decay. [arXiv:2404.05892; hf]"""
from repro_torch.models.config import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        source="arXiv:2404.05892",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=8960, vocab=65_536,
        ssm_state=64, ssm_chunk=64,   # rwkv6 head size 64 -> 40 heads
        supports_decode=True, supports_long_context=True,
    )
