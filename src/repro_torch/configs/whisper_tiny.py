"""whisper-tiny [audio] — 4L enc + 4L dec, d=384 6H d_ff=1536 vocab=51865,
enc-dec with stubbed conv frontend. [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        source="arXiv:2212.04356",
        n_layers=4, enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        head_dim=64, d_ff=1536, vocab=51_865, act="gelu",
        tie_embeddings=True, n_frames=1500,
        supports_decode=True, supports_long_context=False,
    )
