"""Shared pieces of the benchmark's tests: the checkout on the import path,
the ``card`` marker, and the tiny copy of the benchmark's data that the CPU
runs of the harness take (``tiny.py``).

    python -m pytest benchmark/tests -q

Tests marked ``card`` run the check's control on an NVIDIA card; here they
skip, from inside the ``card`` fixture, with the reason.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.tests.tiny import write_tiny  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False here)")
    return torch.device("cuda")


@pytest.fixture
def tiny(tmp_path) -> Path:
    return write_tiny(tmp_path)


@pytest.fixture(scope="session")
def cells() -> list[str]:
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
