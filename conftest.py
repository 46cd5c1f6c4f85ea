"""Fixtures for every test directory: the program's tracing sessions
(``repro_torch.tracing``) are process-wide, so each test starts and ends
with none, and a window's readers never find another test's session."""
import pytest


@pytest.fixture(autouse=True)
def _no_tracing_session():
    try:
        from repro_torch import tracing
    except ImportError:  # the package is not on the path
        yield
        return
    tracing._current = tracing._last = None
    yield
    tracing._current = tracing._last = None
