"""Step watchdog: hang detection + straggler statistics.

A copy of the reference's framework-free ``src/repro/ft/watchdog.py`` (the
port imports nothing of the reference package).

At thousand-node scale the common failure is not a clean crash but a
*silent stall* (one chip wedged inside a collective) or a persistent
straggler (one host at 70% step rate dragging every synchronous step). The
watchdog runs host-side:

* ``deadline``: if no step completes within ``deadline_s``, the registered
  ``on_hang`` callback fires (default: raise in the main thread's next
  check — the launcher turns that into kill+restart-from-checkpoint).
* straggler stats: an EWMA of step time and a robust z-score of the last
  step; sustained outliers trip ``on_straggler`` (the launcher's policy is
  to demote the slow host / shrink the mesh via the elastic runner).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass
class StragglerStats:
    ewma_s: float = 0.0
    var_ewma: float = 0.0
    n: int = 0
    slow_streak: int = 0
    threshold: float = 2.0        # step considered slow if > threshold x ewma
    streak_to_flag: int = 3

    def observe(self, dt: float) -> bool:
        """Returns True when a sustained straggler pattern is detected."""
        if self.n == 0:
            self.ewma_s = dt
        alpha = 0.1
        slow = self.n > 3 and dt > self.threshold * self.ewma_s
        self.slow_streak = self.slow_streak + 1 if slow else 0
        # slow steps damp the mean update so one straggler doesn't poison it
        beta = alpha * (0.25 if slow else 1.0)
        self.ewma_s = (1 - beta) * self.ewma_s + beta * dt
        self.var_ewma = (1 - alpha) * self.var_ewma + alpha * (dt - self.ewma_s) ** 2
        self.n += 1
        return self.slow_streak >= self.streak_to_flag


class StepWatchdog:
    """Context-managed heartbeat around the training loop."""

    def __init__(self, deadline_s: float = 600.0, on_hang=None,
                 on_straggler=None, poll_s: float = 1.0):
        self.deadline_s = deadline_s
        self.on_hang = on_hang
        self.on_straggler = on_straggler
        self.poll_s = poll_s
        self.stats = StragglerStats()
        self._last_beat = time.monotonic()
        self._last_step_start = time.monotonic()
        self._stop = threading.Event()
        self.hang_detected = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        return False

    def step_started(self):
        self._last_step_start = time.monotonic()
        self._last_beat = self._last_step_start

    def step_finished(self) -> float:
        now = time.monotonic()
        dt = now - self._last_step_start
        self._last_beat = now
        if self.stats.observe(dt) and self.on_straggler:
            self.on_straggler(self.stats)
        return dt

    def _watch(self):
        while not self._stop.is_set():
            time.sleep(self.poll_s)
            if time.monotonic() - self._last_beat > self.deadline_s:
                self.hang_detected.set()
                if self.on_hang:
                    self.on_hang()
                return

    def check(self):
        """Call from the main loop; raises if the watcher flagged a hang."""
        if self.hang_detected.is_set():
            raise TimeoutError(
                f"no step heartbeat for > {self.deadline_s}s — assuming a "
                "wedged collective; restart from the last checkpoint")
