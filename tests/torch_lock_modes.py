"""The lock plane's modes for the port's tests.

``debug_mode`` is the reference's fixture (``tests/test_locking.py``):
the sentinels of ``d4pg_tpu_torch.core.locking`` armed in raise mode for
one test, the counters reset before and after. A test module takes it
with ``from torch_lock_modes import debug_mode``."""

from __future__ import annotations

import pytest

from d4pg_tpu_torch.core import locking


@pytest.fixture
def debug_mode():
    locking.enable_debug(raise_on_violation=True)
    locking.reset_stats()
    yield
    locking.disable_debug()
    locking.reset_stats()
