"""grok-1-314b [moe] — 64L d6144 48H(kv8) d_ff=32768 vocab=131072;
8 experts top-2 [hf:xai-org/grok-1]. Routed experts use the gated-SiLU
form of this framework (grok's GeGLU variant differs only in the
activation; noted in docs/ARCHITECTURE.md §7)."""

from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32_768,
        vocab=131_072,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_expert=32_768),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_expert=128),
        dtype="float32",
    )
