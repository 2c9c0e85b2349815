"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` (the
card's cases, marked ``cuda``, skip without a card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _cache_in_tmp(tmp_path, monkeypatch):
    """Datasets a test writes go under its own temporary directory."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
