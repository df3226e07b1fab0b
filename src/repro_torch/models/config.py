"""Architecture configuration dataclasses: a copy of
``repro.models.config`` (pure data, no framework)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts
    top_k: int
    n_shared: int = 0         # always-on shared experts
    d_expert: int = 0         # per-expert FFN width (0 -> use d_ff)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 128          # SSD chunk length


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    attn_every: int = 6       # shared attn block after every k ssm layers


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_type: str = "silu"    # silu (gated) | gelu (plain)
    norm: str = "rms"         # rms | nonparam (olmo)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # modality frontend stubs (vlm/audio): number of precomputed
    # frame/patch embeddings prepended to the token sequence
    n_frontend_embeds: int = 0
    # numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    # true sub-quadratic context support (ssm/hybrid) — gates long_500k
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    def n_params(self) -> int:
        """Total parameter count (for 6ND roofline math)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            per = self._ssm_layer_params()
            return emb + self.n_layers * per
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.qkv_bias:
            attn += hd * (self.n_heads + 2 * self.n_kv_heads)
        if self.moe:
            fe = self.moe.d_expert or f
            mlp = self.moe.n_experts * 3 * d * fe + d * self.moe.n_experts
            mlp += self.moe.n_shared * 3 * d * fe
        elif self.mlp_type == "silu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        norms = 2 * d if self.norm == "rms" else 0
        if self.family == "hybrid":
            ssm_per = self._ssm_layer_params()
            n_shared_blocks = 1
            shared = attn + 3 * d * f + (2 * d if self.norm == "rms" else 0)
            return emb + self.n_layers * ssm_per + n_shared_blocks * shared
        return emb + self.n_layers * (attn + mlp + norms)

    def _ssm_layer_params(self) -> int:
        s = self.ssm
        d = self.d_model
        din = self.d_inner
        gn = s.n_groups * s.d_state
        h = self.ssm_heads
        in_proj = d * (2 * din + 2 * gn + h)
        conv = s.conv_kernel * (din + 2 * gn)
        extras = 3 * h + din  # A_log, D, dt_bias, gated-norm
        out_proj = din * d
        norm = d if self.norm == "rms" else 0
        return in_proj + conv + extras + out_proj + norm

    def n_active_params(self) -> int:
        """Active params per token (MoE: shared + top-k routed only)."""
        if not self.moe:
            return self.n_params()
        d, v = self.d_model, self.vocab
        fe = self.moe.d_expert or self.d_ff
        hd = self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        active_mlp = (self.moe.top_k + self.moe.n_shared) * 3 * d * fe
        router = d * self.moe.n_experts
        norms = 2 * d if self.norm == "rms" else 0
        return emb + self.n_layers * (attn + active_mlp + router + norms)
