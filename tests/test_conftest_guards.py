"""The suite-wide settings of the repo's root ``conftest.py``: one torch
thread a process, and the per-test time limit."""
import signal
import time

import pytest
import torch

from _time_limit import TimeLimitExceeded, time_limit


def test_torch_runs_one_thread():
    assert torch.get_num_threads() == 1


def test_time_limit_stops_a_long_body():
    with pytest.raises(TimeLimitExceeded):
        with time_limit(0.2):
            time.sleep(2)


def test_time_limit_gives_the_enclosing_timer_back():
    before = signal.getitimer(signal.ITIMER_REAL)[0]
    with time_limit(60):
        with time_limit(5):
            pass
        inner_after = signal.getitimer(signal.ITIMER_REAL)[0]
    after = signal.getitimer(signal.ITIMER_REAL)[0]
    assert 59 < inner_after <= 60
    assert after == pytest.approx(before, abs=1)
    assert after <= before


def test_an_enclosing_time_limit_fires_inside_a_longer_one():
    with pytest.raises(TimeLimitExceeded, match="0.2 s"):
        with time_limit(0.2):
            with time_limit(5):
                time.sleep(2)
