"""Registers the ``cuda`` marker of the port's card-only tests.

The tests in this directory launch CUDA kernels and skip without a
card.  They import no JAX, so on a machine without it (where the
repository's top-level conftest cannot load) run them with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/cuda
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips on CPU-only machines)"
    )
