"""LM substrate on PyTorch: every family of ``repro.models``.

``dense``, ``vlm`` and ``audio`` share one decoder — GQA attention and a
(gated) MLP per block, stacked parameters with a leading L axis walked
by a Python loop; ``moe`` swaps the MLP for routed experts plus a fused
shared-expert MLP (``moe.moe_ffn``); ``ssm`` stacks Mamba2 SSD blocks
(``mamba2.mamba_block``) and ``hybrid`` puts one weight-shared attention
block after every ``attn_every`` of them.  Prefill attention is
``modules.chunked_attention``, which launches the hand-written flash
kernel on CUDA tensors; decode attention is a plain grouped einsum over
the KV cache.  Training: ``steps.loss_fn`` and ``steps.make_train_step``
differentiate the dict-tree params with ``torch.autograd.grad``;
attention's gradient recomputes the plain body one query chunk at a
time (``kernels.flash_attention.FlashAttentionFn``).
"""

from repro_torch.models.config import (
    HybridConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from repro_torch.models.steps import (
    MOE_AUX_WEIGHT,
    decode_cache,
    greedy_decode,
    loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.models.transformer import (
    Cache,
    cache_specs,
    forward,
    init_cache,
    init_params,
    param_specs,
    params_from_jax,
    params_to_numpy,
)

__all__ = [
    "MOE_AUX_WEIGHT",
    "Cache",
    "HybridConfig",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "cache_specs",
    "decode_cache",
    "forward",
    "greedy_decode",
    "init_cache",
    "init_params",
    "loss_fn",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
    "param_specs",
    "params_from_jax",
    "params_to_numpy",
]
