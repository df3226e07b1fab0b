"""mamba2-130m [ssm] — 24L d768 attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060].
d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads. Sub-quadratic:
runs the long_500k cell. The paper's attention-sharding candidates are
inapplicable (attention-free) — the X/Y/Z kernel aspects still apply to
its matmuls; see docs/ARCHITECTURE.md §7."""

from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=1,       # unused (attention-free)
        n_kv_heads=1,
        d_ff=0,
        vocab=50_280,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_kernel=4),
        tie_embeddings=True,
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m-smoke",
        family="ssm",
        n_layers=3,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab=512,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, chunk=8),
        tie_embeddings=True,
        subquadratic=True,
        dtype="float32",
    )
