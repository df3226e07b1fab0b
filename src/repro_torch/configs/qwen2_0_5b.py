"""qwen2-0.5b [dense] — 24L d896 14H(kv2) d_ff=4864 vocab=151936;
GQA with QKV bias, tied embeddings [arXiv:2407.10671]. The model the
port serves at full width on one card (``chip_smoke.py``)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab=151_936,
        qkv_bias=True,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,  # kv=2 keeps the 7:1-style grouping exercised
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        qkv_bias=True,
        tie_embeddings=True,
        dtype="float32",
    )
