"""Fault tolerance and straggler mitigation for the training loop.

Port of ``repro/distributed/fault.py`` (pure Python, unchanged: it never
touched JAX).

Three mechanisms, composable around any step function:

  * :class:`ResilientRunner` -- retries a failing step (transient XLA /
    host errors), and after ``max_retries`` escalates to a checkpoint
    restore ("restart from last good state"), exactly the
    checkpoint/restart discipline a 1000-node job needs.  Failure
    injection hooks make this testable without real hardware faults.

  * :class:`StragglerMonitor` -- tracks per-step wall times; a step slower
    than ``threshold`` x the rolling median is flagged.  On a real
    multi-pod deployment the flag triggers the documented mitigations
    (re-shard away from the slow host / skip its optimizer gather once);
    here it records and reports, and the train loop uses it to decide to
    rebuild its data prefetcher (the single-process analogue).

  * :class:`Heartbeat` -- a liveness file other processes (or a cluster
    agent) can watch; missed beats -> the agent restarts the job, which
    then resumes from the latest checkpoint (checkpoint/ckpt.restore).
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import time


class StepFailure(RuntimeError):
    pass


class ResilientRunner:
    def __init__(self, step_fn, *, max_retries: int = 2,
                 on_restore=None, failure_injector=None):
        self.step_fn = step_fn
        self.max_retries = max_retries
        self.on_restore = on_restore
        self.failure_injector = failure_injector
        self.retries_total = 0
        self.restores_total = 0

    def run_step(self, *args, **kwargs):
        attempt = 0
        while True:
            try:
                if self.failure_injector is not None:
                    self.failure_injector()
                return self.step_fn(*args, **kwargs)
            except StepFailure:
                attempt += 1
                self.retries_total += 1
                if attempt > self.max_retries:
                    if self.on_restore is None:
                        raise
                    args, kwargs = self.on_restore(*args, **kwargs)
                    self.restores_total += 1
                    attempt = 0


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold: float = 2.5):
        self.window = window
        self.threshold = threshold
        self.times = collections.deque(maxlen=window)
        self.straggler_steps: list[int] = []
        self._t0 = None
        self._step = 0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        """Record one step; True if it was a straggler."""
        dt = time.monotonic() - self._t0
        is_straggler = False
        if len(self.times) >= max(self.window // 4, 4):
            med = statistics.median(self.times)
            if dt > self.threshold * med:
                is_straggler = True
                self.straggler_steps.append(self._step)
        self.times.append(dt)
        self._step += 1
        return is_straggler

    @property
    def median_s(self):
        return statistics.median(self.times) if self.times else float("nan")


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, step: int):
        now = time.time()
        if now - self._last < self.interval_s:
            return
        self._last = now
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": now}, f)
        os.replace(tmp, self.path)

    @staticmethod
    def is_alive(path: str, stale_s: float = 60.0) -> bool:
        try:
            with open(path) as f:
                beat = json.load(f)
        except (OSError, ValueError):
            return False
        return (time.time() - beat["time"]) < stale_s
