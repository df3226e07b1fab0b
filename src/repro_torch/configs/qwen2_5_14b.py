"""qwen2.5-14b [dense] — 48L d5120 40H(kv8) d_ff=13824 vocab=152064;
GQA with QKV bias [arXiv:2412.15115 / hf:Qwen]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=13_824,
        vocab=152_064,
        qkv_bias=True,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        qkv_bias=True,
        dtype="float32",
    )
