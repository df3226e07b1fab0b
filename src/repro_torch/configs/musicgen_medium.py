"""musicgen-medium [audio] — 48L d1536 24H(kv24) d_ff=6144 vocab=2048;
decoder-only over EnCodec tokens [arXiv:2306.05284]. The EnCodec /
text-conditioning frontend is a STUB: the JAX package's input_specs()
provides 64 precomputed conditioning frame embeddings; the token stream
is a single interleaved EnCodec codebook stream (delay-pattern
flattening), vocab 2048. Standard (non-gated) GELU MLP."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab=2048,
        mlp_type="gelu",
        n_frontend_embeds=64,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        mlp_type="gelu",
        n_frontend_embeds=8,
        dtype="float32",
    )
