"""Test suite (a package, so `tests.conftest` resolves to this repo)."""
