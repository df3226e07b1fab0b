"""Elastic re-meshing: continue training after losing (or gaining)
devices — the counterpart of ``repro.runtime.elastic``.

Procedure:
  1. take each leaf to one whole tensor (a host tensor as it is, a
     DTensor through ``full_tensor()``),
  2. build a new ``DeviceMesh`` over the surviving devices,
  3. recompute the sharding plan for the SAME ShardScheme against the
     new mesh (all divisibility guards re-evaluate automatically),
  4. place every leaf as a DTensor with its new sharding.

The serving-side elastic control loop lives in
:mod:`repro_torch.cluster.elastic`, which re-exports
:func:`remesh_state` as the state-migration hook for pool-size changes.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import (
    ShardScheme,
    distribute,
    make_param_shardings,
)

__all__ = ["remesh_state"]


def remesh_state(
    cfg: ModelConfig,
    state: Any,
    new_mesh,
    scheme: Optional[ShardScheme] = None,
) -> Any:
    """Reshard a params-like tree of tensors or DTensors onto `new_mesh`
    (a ``torch.distributed.device_mesh.DeviceMesh``): every leaf a
    DTensor placed by ``make_param_shardings`` against the new mesh."""
    shardings = make_param_shardings(cfg, new_mesh, state, scheme)
    return distribute(state, shardings)
