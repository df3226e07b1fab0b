"""Launchers: ``python -m repro_torch.launch.serve`` prefills and
greedily decodes a batch of prompts (see its docstring);
:mod:`repro_torch.launch.hillclimb` holds the BNN mapping hillclimb."""

__all__ = []
