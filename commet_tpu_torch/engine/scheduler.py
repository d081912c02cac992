"""Job-DAG scheduler: the replacement for the reference's SGE mode
(Commet.py:119,204-236,580-582 - qsub + hold_jid dependency chains over a
shared filesystem). The port's copy of commet_tpu/engine/scheduler.py.

The reference models the all-vs-all pipeline as a job DAG:

    filter(file) ...                (all independent)
        └─► all_in_Si               (per reference set Si, needs all filters)
              └─► Si_in_X           (per later set X, needs all_in_Si)
                    └─► X_in_Si     (needs Si_in_X)
                                └─► analysis (needs everything)

Here the same DAG is executed in-process with a thread pool: host-bound
stages (filtering, parsing, IO) run concurrently, while stages that need
the card serialize through ``device_lock``: a ``device`` job holds it for
its whole body, a host job takes it around its device stage. State still flows through .bv
files, so any failed stage can be re-run and completed stages are skipped
on resume (the reference's implicit restartability, kept deliberately). The
first job error is re-raised as RuntimeError("job failed: ...") once the
running jobs end.
"""

from __future__ import annotations

import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


@dataclass
class Job:
    name: str
    fn: Callable[[], None]
    deps: Sequence[str] = ()
    device: bool = False          # serialize through the device lock
    done_check: Optional[Callable[[], bool]] = None  # skip if already done

    # runtime state
    done: bool = field(default=False, init=False)
    error: Optional[BaseException] = field(default=None, init=False)


class JobGraph:
    """Dependency-ordered executor with bounded host parallelism and a
    single-device serialization lock."""

    def __init__(self, workers: int = 2):
        self.jobs: Dict[str, Job] = {}
        self.workers = workers
        self.device_lock = threading.Lock()

    def add(self, name: str, fn: Callable[[], None],
            deps: Sequence[str] = (), device: bool = False,
            done_check: Optional[Callable[[], bool]] = None) -> str:
        if name in self.jobs:
            raise ValueError(f"duplicate job {name}")
        self.jobs[name] = Job(name, fn, tuple(deps), device, done_check)
        return name

    def run(self) -> None:
        pending = dict(self.jobs)
        for job in pending.values():
            for d in job.deps:
                if d not in self.jobs:
                    raise ValueError(f"job {job.name} depends on unknown {d}")

        lock = threading.Lock()
        cond = threading.Condition(lock)
        errors: List[BaseException] = []

        def ready(job: Job) -> bool:
            return all(self.jobs[d].done for d in job.deps)

        def run_job(job: Job) -> None:
            try:
                if job.done_check is not None and job.done_check():
                    pass  # resume: output already present
                elif job.device:
                    with self.device_lock:
                        job.fn()
                else:
                    job.fn()
            except BaseException as exc:  # noqa: BLE001
                job.error = exc
                with cond:
                    errors.append(exc)
                    cond.notify_all()
                traceback.print_exc()
                return
            with cond:
                job.done = True
                cond.notify_all()

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            submitted = set()
            with cond:
                while True:
                    if errors:
                        raise RuntimeError(
                            f"job failed: {errors[0]}") from errors[0]
                    for name, job in self.jobs.items():
                        if (name not in submitted and not job.done
                                and ready(job)):
                            submitted.add(name)
                            pool.submit(run_job, job)
                    if all(j.done for j in self.jobs.values()):
                        break
                    cond.wait(timeout=0.5)
