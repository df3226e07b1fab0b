"""zamba2-7b [hybrid] — 81 Mamba2 layers d3584, shared attention block
32H(kv32) d_ff=14336, vocab=32000, ssm_state=64 [arXiv:2411.15242].
Shared transformer block (single weight set) applied after every 6
Mamba2 layers — the weight-sharing scheme that defines the Zamba
family. Sub-quadratic: runs the long_500k cell."""

from repro_torch.models.config import ModelConfig, SSMConfig, HybridConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14_336,
        vocab=32_000,
        ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_kernel=4),
        hybrid=HybridConfig(attn_every=6),
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke",
        family="hybrid",
        n_layers=7,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, chunk=8),
        hybrid=HybridConfig(attn_every=3),
        subquadratic=True,
        dtype="float32",
    )
