"""olmo-1b [dense] — 16L d2048 16H(kv16) d_ff=8192 vocab=50304;
non-parametric LayerNorm (no scale/bias), tied embeddings
[arXiv:2402.00838]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=50_304,
        norm="nonparam",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        norm="nonparam",
        tie_embeddings=True,
        dtype="float32",
    )
