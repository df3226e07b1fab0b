"""The per-layer implementation space (paper §II-C / §III-B).

The paper fixes 8 implementations per layer: CPU (sequential,
host-placed) and the 7 parallel configurations over the Data (X) /
Window (Y) / Neuron (Z) aspects — ``CONFIGS`` below, the legacy
fixed-8 space every profile row still contains.

Beyond the paper, the space is **open**: any name registered in
:mod:`repro_torch.kernels.registry` is a valid per-layer config.
``validate``/``aspects_of`` consult the registry, so mappings over
variable-size config spaces flow through the same code paths as the
fixed-8 ones.
"""

from __future__ import annotations

CPU = "CPU"
ASPECT_CONFIGS = ("X", "Y", "Z", "XY", "XZ", "YZ", "XYZ")
CONFIGS = (CPU,) + ASPECT_CONFIGS

# paper Fig. 5 baselines
NAIVE_GPU = "X"        # "naive": Data-only everywhere
FULL_GPU = "XYZ"       # "fully-parallel": everything, max parallel


def _registry():
    # deferred: kernels.registry pulls in the kernel modules; keep this
    # module cheap
    from repro_torch.kernels import registry

    return registry.DEFAULT_REGISTRY


def aspects_of(config: str) -> tuple:
    """'XZ' -> ('X', 'Z'); 'CPU' -> (); registered variants (e.g.
    'seg_cuda') -> their declared aspect metadata."""
    if config == CPU:
        return ()
    if config in CONFIGS:
        return tuple(config)
    reg = _registry()
    if config in reg:
        return tuple(reg.get(config).aspects)
    raise ValueError(f"unknown parallel config {config!r}")


def validate(config: str) -> str:
    """Accept the fixed-8 names and any registered kernel variant."""
    if config in CONFIGS or config in _registry():
        return config
    raise ValueError(f"unknown parallel config {config!r}")


def is_host_config(config: str, registry=None) -> bool:
    """True iff `config` is host-placed (no boundary cost).  The single
    placement authority: ``CPU`` plus any registered variant declaring
    ``placement="host"``; every other *registered* name is
    device-placed.  Unknown names raise (a typo priced as "device"
    would silently corrupt mappings).  Pass `registry` to resolve
    against a custom registry (profiling sweeps); mapping, serving and
    execution resolve against the default registry, so variants used
    beyond profiling must be registered globally."""
    if config == CPU:
        return True
    if config in CONFIGS:
        return False
    reg = registry if registry is not None else _registry()
    if config in reg:
        return reg.placement_of(config) == "host"
    if registry is not None and config in _registry():
        return _registry().placement_of(config) == "host"
    raise ValueError(f"unknown parallel config {config!r}")
