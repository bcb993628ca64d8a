"""Shared fixtures of the benchmark's own tests (CPU, tiny sizes; the
tests marked `cuda` run the cells at their own sizes on a card)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where torch.cuda.is_available() is false")


@pytest.fixture
def card():
    """The card, or a skip: decided here, never while a module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no interpret mode)")
    return torch.device("cuda:0")


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path

