"""llava-next-mistral-7b [vlm] — Mistral-7B backbone: 32L d4096
32H(kv8) d_ff=14336 vocab=32000 [hf:llava-hf/llava-v1.6-mistral-7b-hf].
The anyres vision frontend is a STUB: the JAX package's input_specs()
provides 576 precomputed patch embeddings (one 24x24 CLIP grid)
prepended to the token sequence."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14_336,
        vocab=32_000,
        rope_theta=1e6,
        n_frontend_embeds=576,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        n_frontend_embeds=8,
        dtype="float32",
    )
