"""Settings for every process that runs the repo's tests: torch's CPU
intra-op pool on one thread, and a time limit on each test's call."""
import importlib.util
import os
import signal
import sys
import threading

import pytest

# One torch intra-op thread in every test process. The suite runs several
# xdist workers on as many cores; each worker's default pool (one thread a
# core) then leaves every op on the reduced models' tiny tensors waiting on
# threads that have no core, and the port's CPU engine runs go 30-60x
# slower. On an idle machine one thread is no slower for these sizes.
try:
    import torch
except ImportError:
    pass
else:
    torch.set_num_threads(1)

# ``tests/_time_limit.py``, registered under the name the guard tests import
# it by, so the hook and the tests share one ``TimeLimitExceeded``.
_spec = importlib.util.spec_from_file_location(
    "_time_limit", os.path.join(os.path.dirname(__file__), "tests",
                                "_time_limit.py"))
_time_limit = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_time_limit)
sys.modules["_time_limit"] = _time_limit

# Each test's call fails once it has run this long, so a hang costs one
# test and not the whole run. No test comes within 3x of it.
TEST_TIME_LIMIT_S = 300


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if (not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return
    with _time_limit.time_limit(TEST_TIME_LIMIT_S):
        yield
