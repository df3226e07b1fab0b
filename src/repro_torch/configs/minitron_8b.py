"""minitron-8b [dense] — 32L d4096 32H(kv8) d_ff=16384 vocab=256000;
pruned nemotron with squared-ReLU MLP [arXiv:2407.14679]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16_384,
        vocab=256_000,
        mlp_type="relu2",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        mlp_type="relu2",
        dtype="float32",
    )
