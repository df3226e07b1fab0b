"""LM substrate on PyTorch: the attention families of ``repro.models``.

``dense``, ``vlm`` and ``audio`` share one decoder — GQA attention and a
(gated) MLP per block, stacked parameters with a leading L axis walked
by a Python loop.  Prefill attention is ``modules.chunked_attention``,
which launches the hand-written flash kernel on CUDA tensors; decode
attention is a plain grouped einsum over the KV cache.  The ``moe``,
``ssm`` and ``hybrid`` families and the train step are not ported yet
and raise ``NotImplementedError``.
"""

from repro_torch.models.config import (
    HybridConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from repro_torch.models.steps import (
    greedy_decode,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.models.transformer import (
    Cache,
    forward,
    init_cache,
    init_params,
    params_from_jax,
    params_to_numpy,
)

__all__ = [
    "Cache",
    "HybridConfig",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "forward",
    "greedy_decode",
    "init_cache",
    "init_params",
    "make_prefill_step",
    "make_serve_step",
    "params_from_jax",
    "params_to_numpy",
]
