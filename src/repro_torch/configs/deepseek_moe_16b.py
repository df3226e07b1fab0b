"""deepseek-moe-16b [moe] — 28L d2048 16H(kv16) expert_ff=1408
vocab=102400; 2 shared + 64 routed top-6, fine-grained experts
[arXiv:2401.06066]. Simplification vs HF: the real model's first layer
uses a dense MLP; here all 28 layers are MoE (noted in docs/ARCHITECTURE.md §7)."""

from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=102_400,
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=2, d_expert=32),
        dtype="float32",
    )
