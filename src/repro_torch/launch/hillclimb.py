"""The BNN *mapping* hillclimb: local search over per-layer
implementations whose move space is each profile row's own candidate
set — the kernel-variant registry's variable-size per-layer spaces the
DP mapper searches — not the hard-coded fixed 8.

Pure logic over a :class:`~repro_torch.core.profiler.ProfileTable`.
The rest of the JAX package's ``repro.launch.hillclimb`` (the scheme
variants compiled and lowered through XLA) has no counterpart here.
"""

from __future__ import annotations

from repro_torch.core.mapper import attribute_fused_costs, price_mapping


def _fused_total(table, batch, mapping) -> float:
    kernels, boundaries = attribute_fused_costs(table, batch, mapping)
    return sum(kernels) + sum(boundaries)


def bnn_mapping_hillclimb(
    table, *, batch=None, start=None, max_sweeps: int = 50
):
    """First-improvement hillclimb over per-layer configs under the
    fused cost model (the DP's objective).

    The move space for layer *i* at batch *b* is
    ``table.configs_for(b, i)`` — the row's own registry-driven
    candidate set, so tables with registered variants are climbed over
    their full variable-size spaces; nothing assumes the paper's fixed
    8.

    ``start=None`` seeds each batch's climb from the paper's greedy
    per-layer argmin.  Sweeps layers repeatedly until a full sweep
    finds no improving move (or ``max_sweeps``), then returns
    ``(EfficientConfiguration, trajectory)`` for the best batch size,
    where ``trajectory`` is the accepted-total series (before -> after
    per accepted move).  The DP is exact for this objective, so the
    result is sandwiched: DP total <= hillclimb total <= start total.
    """
    batches = table.batch_sizes if batch is None else (batch,)
    best = None                      # (total, batch, mapping, trajectory)
    n_layers = len(table.layer_labels)
    for b in batches:
        if start is None:
            mapping = [
                min(
                    table.configs_for(b, i),
                    key=lambda c: table.times[b][i][c],
                )
                for i in range(n_layers)
            ]
        else:
            mapping = list(start)
        total = _fused_total(table, b, mapping)
        trajectory = [total]
        for _ in range(max_sweeps):
            improved = False
            for i in range(n_layers):
                for cand in table.configs_for(b, i):
                    if cand == mapping[i]:
                        continue
                    prev = mapping[i]
                    mapping[i] = cand
                    t = _fused_total(table, b, mapping)
                    if t < total:
                        total = t
                        trajectory.append(t)
                        improved = True
                    else:
                        mapping[i] = prev
            if not improved:
                break
        if best is None or total < best[0]:
            best = (total, b, tuple(mapping), trajectory)
    total, b, mapping, trajectory = best
    return price_mapping(table, b, mapping), trajectory


__all__ = ["bnn_mapping_hillclimb"]
