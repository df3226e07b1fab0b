"""Launchers: ``python -m repro_torch.launch.serve`` prefills and
greedily decodes a batch of prompts, ``python -m
repro_torch.launch.train`` trains an LM on the token stream (see their
docstrings);
``python -m repro_torch.launch.dryrun`` traces each (architecture x
shape) cell's sharded step on a fake 256-rank DeviceMesh and records
its per-device memory, collectives and roofline
(:mod:`repro_torch.launch.trace_analysis` reads the trace);
``python -m repro_torch.launch.hillclimb`` dry-runs the scheme variants
of the chosen cells and holds the BNN mapping hillclimb;
:mod:`repro_torch.launch.mesh` builds DeviceMeshes, abstract meshes,
a one-rank process group and a fake one of any size."""

__all__ = []
