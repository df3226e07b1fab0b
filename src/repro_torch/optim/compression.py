"""Gradient compression for a cross-device all-reduce.

* **bf16** — cast grads to bfloat16 before the all-reduce, halving the
  bytes on the wire.  torch rounds float32 to bfloat16 to nearest, ties
  to even, as the JAX package does.
* **int8 + error feedback** — quantize to int8 with a per-tensor scale
  and carry the quantization error into the next step.  ``torch.round``
  rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import flatten, leaves, tree_map, unflatten


def compress_bf16(grads):
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress_bf16(grads):
    return tree_map(lambda g: g.to(torch.float32), grads)


class Int8ErrorFeedback(NamedTuple):
    """Carries per-leaf residual error between steps."""

    residual: Any

    @staticmethod
    def init(grads) -> "Int8ErrorFeedback":
        return Int8ErrorFeedback(
            tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
        )

    @torch.no_grad()
    def compress(self, grads):
        """Return (int8 payload, scales, new_state).  The payload is what
        goes over the wire."""

        def one(g, r):
            g = g.float() + r
            scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            err = g - q.float() * scale
            return q, scale, err

        flat, tdef = flatten(grads)
        out = [one(g, r) for g, r in zip(flat, leaves(self.residual))]
        payload = unflatten(tdef, [o[0] for o in out])
        scales = unflatten(tdef, [o[1] for o in out])
        new_state = Int8ErrorFeedback(unflatten(tdef, [o[2] for o in out]))
        return payload, scales, new_state

    @staticmethod
    def decompress(payload, scales):
        return tree_map(lambda q, s: q.float() * s, payload, scales)
