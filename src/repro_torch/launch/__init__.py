"""Launchers: ``python -m repro_torch.launch.serve`` prefills and
greedily decodes a batch of prompts, ``python -m
repro_torch.launch.train`` trains an LM on the token stream (see their
docstrings);
:mod:`repro_torch.launch.hillclimb` holds the BNN mapping hillclimb;
:mod:`repro_torch.launch.mesh` builds DeviceMeshes, abstract meshes
and a one-rank process group."""

__all__ = []
