"""qwen1.5-32b [dense] — 64L d=5120 40H (MHA kv=40) d_ff=27392 vocab=152064,
QKV bias. [hf:Qwen/Qwen1.5-32B; hf]"""
from repro_torch.models.config import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        source="hf:Qwen/Qwen1.5-32B",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
        d_ff=27_392, vocab=152_064, qkv_bias=True,
        kv_dtype="int8",  # MHA whale: int8 KV keeps decode_32k under HBM
        supports_decode=True, supports_long_context=False,
    )
