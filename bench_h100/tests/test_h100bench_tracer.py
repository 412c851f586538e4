"""The traced slice's hand-offs between the serving loop and the main
thread, with a stand-in for torch's CUDA calls and the profiler."""
import threading
import time
from types import SimpleNamespace

from bench_h100.trace import Tracer


class FakeProfile:
    def __init__(self, calls):
        self.calls = calls

    def prepare_trace(self):
        self.calls.append(("prepare", threading.current_thread().name))
        time.sleep(0.05)

    def start_trace(self):
        self.calls.append(("start", threading.current_thread().name))

    def stop_trace(self):
        self.calls.append(("stop", threading.current_thread().name))
        time.sleep(0.05)


def test_profiler_runs_on_the_main_thread_while_the_loop_waits():
    calls, events = [], []
    cuda = SimpleNamespace(synchronize=lambda: events.append("sync"),
                           _sleep=lambda n: events.append("marker"))
    paused, resumed = [], []
    tr = Tracer(SimpleNamespace(cuda=cuda), 0.2, lambda: paused.append(1),
                lambda dt: resumed.append(dt))
    tr._profile = lambda: FakeProfile(calls)
    now = time.perf_counter()
    tr.t_start = now + 0.1
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            tr.before_dispatch()
            time.sleep(0.002)
    th = threading.Thread(target=loop, name="loop")
    th.start()
    tr.serve(now + 5.0)
    stop.set()
    th.join(5.0)
    assert not th.is_alive()
    assert [c for c, _ in calls] == ["prepare", "start", "stop"]
    assert {t for _, t in calls} == {threading.current_thread().name}
    assert tr.state == "done" and tr.t_start <= tr.host0 < tr.host1
    # the slice runs its full length after the start-up pause
    assert tr.host1 >= tr.host0 + 0.2 and paused == [1] and len(resumed) == 2
    assert resumed[0] >= 0.05 and resumed[1] >= 0.05
    assert events.count("marker") == 1 and events.count("sync") >= 2
    assert set(tr.times) == {"prepare_s", "start_s", "stop_s"}
