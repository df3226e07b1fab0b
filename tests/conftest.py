"""Pytest settings: the marker for tests that need a CUDA device."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels have no CPU "
        "mode); skips without one",
    )
