"""The port's job-DAG scheduler (commet_tpu_torch.engine.scheduler):
ordering, device serialization, resume, errors; the cases of
tests/test_scheduler.py, importing only the port."""

import threading
import time

import pytest

from commet_tpu_torch.engine.scheduler import JobGraph


def test_dependency_order():
    order = []
    g = JobGraph(workers=4)
    g.add("a", lambda: order.append("a"))
    g.add("b", lambda: order.append("b"), deps=["a"])
    g.add("c", lambda: order.append("c"), deps=["a"])
    g.add("d", lambda: order.append("d"), deps=["b", "c"])
    g.run()
    assert order[0] == "a"
    assert order[-1] == "d"
    assert set(order) == {"a", "b", "c", "d"}


def test_device_jobs_serialize():
    active = []
    max_active = []
    lock = threading.Lock()

    def dev_job():
        with lock:
            active.append(1)
            max_active.append(len(active))
        time.sleep(0.05)
        with lock:
            active.pop()

    g = JobGraph(workers=4)
    for i in range(6):
        g.add(f"d{i}", dev_job, device=True)
    g.run()
    assert max(max_active) == 1  # never two device jobs at once


def test_done_check_skips():
    ran = []
    g = JobGraph(workers=2)
    g.add("skipped", lambda: ran.append("x"), done_check=lambda: True)
    g.add("runs", lambda: ran.append("y"), deps=["skipped"])
    g.run()
    assert ran == ["y"]


def test_error_propagates():
    def boom():
        raise ValueError("nope")

    g = JobGraph(workers=2)
    g.add("bad", boom)
    g.add("after", lambda: None, deps=["bad"])
    with pytest.raises(RuntimeError, match="job failed: nope"):
        g.run()
    assert not g.jobs["after"].done


def test_unknown_dep_rejected():
    g = JobGraph()
    g.add("a", lambda: None, deps=["ghost"])
    with pytest.raises(ValueError, match="unknown ghost"):
        g.run()


def test_hundred_set_all_vs_all_fanout():
    """The N=100 all-vs-all DAG - 99 step-0 jobs + 4,950 pair chains
    (9,900 refinement jobs) - must schedule, respect the per-round ordering
    invariants, and finish. Job bodies are mocked (the engine's correctness
    at fan-out is covered by the driver tests); this is the scheduler's
    collapse test."""
    n = 100
    order = []
    lock = threading.Lock()

    def mark(name):
        def run():
            with lock:
                order.append(name)
        return run

    g = JobGraph(workers=8)
    for i in range(n - 1):
        g.add(f"all_in_{i}", mark(f"all_in_{i}"), device=True)
        for j in range(i + 1, n):
            a = g.add(f"{i}_in_{j}", mark(f"{i}_in_{j}"),
                      deps=[f"all_in_{i}"], device=True)
            g.add(f"{j}_in_{i}", mark(f"{j}_in_{i}"), deps=[a], device=True)
    assert len(g.jobs) == (n - 1) + 2 * (n * (n - 1) // 2)
    g.run()
    assert len(order) == len(g.jobs)
    pos = {name: p for p, name in enumerate(order)}
    for i in range(n - 1):
        for j in range(i + 1, n):
            assert pos[f"all_in_{i}"] < pos[f"{i}_in_{j}"] < pos[f"{j}_in_{i}"]
