"""Launchers: ``python -m repro_torch.launch.serve`` prefills and
greedily decodes a batch of prompts (see its docstring)."""

__all__ = []
