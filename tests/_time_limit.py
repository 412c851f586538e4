"""A time limit on a block of code: the test suite's per-test limit (the
repo's root ``conftest.py``) and its guard tests both import it from here."""
import contextlib
import signal
import time


class TimeLimitExceeded(BaseException):
    """A block ran past its time limit. A ``BaseException``, as pytest's own
    outcomes are, so ``except Exception`` in the code under test cannot
    swallow it."""


@contextlib.contextmanager
def time_limit(seconds):
    """Raise ``TimeLimitExceeded`` in the main thread once ``seconds`` have
    passed inside the block (SIGALRM through ``ITIMER_REAL``).

    Limits nest: an enclosing limit that comes first fires inside the block
    with its own error, and on leaving the block the enclosing timer gets
    back what is left of its time."""
    outer_left = signal.getitimer(signal.ITIMER_REAL)[0]
    outer_first = 0 < outer_left <= seconds
    start = time.monotonic()
    fired = False

    def expire(signum, frame):
        nonlocal fired
        fired = True
        if outer_first and callable(previous):
            previous(signum, frame)
        raise TimeLimitExceeded(f"ran past its {seconds} s time limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, outer_left if outer_first else seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        if outer_left and not (outer_first and fired):
            left = outer_left - (time.monotonic() - start)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-6))
