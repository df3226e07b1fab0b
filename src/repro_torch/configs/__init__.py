"""Assigned-architecture registry, pure data: ``get(name)`` -> full
ModelConfig, ``get_smoke(name)`` -> reduced same-family config for CPU
tests, ``input_specs(cfg, shape)`` -> ``meta``-tensor stand-ins per
cell: a copy of ``repro.configs``.

Shapes (assigned to every LM arch):
  train_4k     seq 4,096   global_batch 256   (train_step)
  prefill_32k  seq 32,768  global_batch 32    (prefill_step)
  decode_32k   seq 32,768  global_batch 128   (serve_step, 1 new token)
  long_500k    seq 524,288 global_batch 1     (serve_step; sub-quadratic
                                               archs only)
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig

ARCH_NAMES = (
    "deepseek_moe_16b",
    "grok_1_314b",
    "zamba2_7b",
    "llava_next_mistral_7b",
    "qwen2_5_14b",
    "olmo_1b",
    "minitron_8b",
    "qwen2_0_5b",
    "mamba2_130m",
    "musicgen_medium",
    # the paper's own models live in repro_torch.bnn.models (image BNNs)
)


def _mod(name: str):
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ModelConfig:
    return _mod(canonical(name)).config()


def get_smoke(name: str) -> ModelConfig:
    return _mod(canonical(name)).smoke_config()


def canonical(name: str) -> str:
    n = name.replace("-", "_").replace(".", "_")
    if n not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    return n


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def cell_supported(cfg: ModelConfig, shape: str) -> bool:
    """long_500k requires sub-quadratic context (ssm/hybrid)."""
    if shape == "long_500k":
        return cfg.subquadratic
    return True


def input_specs(cfg: ModelConfig, shape) -> dict:
    """``meta``-tensor stand-ins for every model input of this cell (the
    port's ``jax.ShapeDtypeStruct``): shapes and dtypes, no allocation.
    `shape` is a name of :data:`SHAPES` or a :class:`ShapeCell` of its
    own (``launch.dryrun`` traces steps at other sizes too)."""
    from repro_torch.models.transformer import cache_specs

    sh = shape if isinstance(shape, ShapeCell) else SHAPES[shape]
    nf = cfg.n_frontend_embeds
    t_text = sh.seq - nf
    dt = getattr(torch, cfg.dtype)

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if sh.kind in ("train", "prefill"):
        specs = {"tokens": spec((sh.batch, t_text))}
        if sh.kind == "train":
            specs["labels"] = spec((sh.batch, t_text))
        if nf:
            specs["frontend_embeds"] = spec((sh.batch, nf, cfg.d_model), dt)
        return specs

    # decode: one token against a seq-length cache
    return {
        "token": spec((sh.batch, 1)),
        "cache": cache_specs(cfg, sh.batch, sh.seq),
    }


__all__ = [
    "ARCH_NAMES",
    "SHAPES",
    "ShapeCell",
    "canonical",
    "cell_supported",
    "get",
    "get_smoke",
    "input_specs",
]
