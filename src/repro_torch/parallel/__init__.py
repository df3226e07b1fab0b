"""Distribution: mesh-axis conventions, sharding plans, schemes — the
counterpart of ``repro.parallel``."""

from repro_torch.parallel.sharding import (
    ShardScheme,
    default_scheme,
    make_batch_shardings,
    make_cache_shardings,
    make_opt_shardings,
    make_param_shardings,
)

__all__ = [
    "ShardScheme",
    "default_scheme",
    "make_batch_shardings",
    "make_cache_shardings",
    "make_opt_shardings",
    "make_param_shardings",
]
