"""Elastic run control: checkpoint/restart around a train function.

``ElasticRunner`` owns the restart loop around a train function:

    runner = ElasticRunner(ckpt_dir, mesh_factory, build_state, train_segment)
    runner.run(max_steps)

* ``build_state(mesh, restore_step)`` constructs a ``RunState`` (params,
  opt_state, step) — restoring from the latest checkpoint when one exists
  (the checkpoint layer stores tensors by name, so the restorer chooses
  where they go).
* ``train_segment(runner, state, max_steps)`` runs until it returns
  (completed) or raises (hang/preemption) — the runner drops the failed
  segment's state, rebuilds with whatever ``mesh_factory`` now gives, and
  resumes from the last committed checkpoint.

``mesh_factory`` returns what ``build_state`` places the state on: the
trainer's returns its device, or with ``--mesh-model`` a device mesh.
``RunState``, ``QueueDepthAutoscaler``
and the loop are the reference's (``src/repro/ft/elastic.py``), with three
differences:

* ``ckpt_dir=None`` checkpoints nothing: ``maybe_save`` does nothing and a
  failed segment raises, as there is nothing to resume from;
* before the next segment is built, the failed one's state is dropped (its
  parameters and optimizer state would otherwise stay on the card beside
  the new ones: 15.4 GB for a 1.1 B-parameter model with fp32 master
  weights and moments) and any save still being written is waited for, so
  the restart resumes from it; on a group of several ranks every rank
  waits for rank 0's write, the only one, and restores the step rank 0
  reads;
* a restart is in-process, so it recovers from a Python exception (an
  injected failure, a hang the watchdog reports, an out-of-memory error)
  but not from a sticky CUDA error: an illegal address or a device-side
  assert leaves the process's CUDA context unusable, and every later
  segment fails the same way. That needs a new process. Nor, on a mesh of
  several ranks, from a failure of one rank: the others wait in a
  collective.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Callable

import torch.distributed as dist

from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step


@dataclass
class RunState:
    params: object
    opt_state: object
    step: int
    mesh: object = None
    restarts: int = 0


@dataclass
class QueueDepthAutoscaler:
    """Queue-depth-driven fleet sizing: the reference's policy, decision for
    decision.

    The serving-side face of elastic run control: where :class:`ElasticRunner`
    resizes a training mesh across restarts, this policy resizes a serving
    fleet at a fixed cadence from what a real autoscaler can observe — queue
    depth and running batch occupancy. Nothing in this package calls it yet:
    the fleet simulator that drives it in the reference is not ported.

    Thresholds are in units of FULL BATCHES per instance — a loaded-but-
    stable instance naturally runs with a batch or two waiting, so absolute
    request counts would flap at the correct size:

    * scale UP by one when more than ``high_batches`` full batches per
      instance are waiting AND the backlog is not already draining (an
      undersized fleet has an ever-growing queue; a recovering one should
      not keep adding instances);
    * scale DOWN by one when the queue is near-empty (< ``low_batches``)
      and the running work would fit ``n - 1`` instances at ``down_util``
      batch utilization.
    """

    high_batches: float = 2.0
    low_batches: float = 0.25
    down_util: float = 0.7
    min_instances: int = 1
    max_instances: int = 64
    _last_queued: float = field(default=-1.0, init=False, repr=False)

    def decide(self, n_active: int, queued: int, running: int,
               max_batch: int) -> int:
        # coerce observations so numpy scalars and plain ints drive the
        # same decisions
        n_active, queued, running = int(n_active), int(queued), int(running)
        capacity = max(n_active, 1) * max_batch
        growing = self._last_queued < 0 or queued >= self._last_queued
        self._last_queued = float(queued)
        if queued > self.high_batches * capacity and growing:
            return min(n_active + 1, self.max_instances)
        if (queued < self.low_batches * capacity
                and n_active > self.min_instances
                and running <= (n_active - 1) * max_batch * self.down_util):
            return max(n_active - 1, self.min_instances)
        return n_active


class ElasticRunner:
    def __init__(self, ckpt_dir: str | None, mesh_factory: Callable[[], object],
                 build_state: Callable, train_segment: Callable,
                 max_restarts: int = 10, save_every: int = 100):
        self.ckpt_dir = ckpt_dir
        self.mesh_factory = mesh_factory
        self.build_state = build_state
        self.train_segment = train_segment
        self.max_restarts = max_restarts
        self.save_every = save_every
        self.ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir is not None else None

    def run(self, max_steps: int) -> RunState:
        restarts = 0
        while True:
            mesh = self.mesh_factory()
            start = self._start_step() if self.ckpt is not None else None
            state = self.build_state(mesh, start)
            state.mesh = mesh
            state.restarts = restarts
            try:
                state = self.train_segment(self, state, max_steps)
                if self.ckpt is not None:
                    self.ckpt.wait()
                return state
            except Exception as e:  # noqa: BLE001 — restart-able failure
                restarts += 1
                if self.ckpt is None or restarts > self.max_restarts:
                    raise
                print(f"[elastic] segment failed ({type(e).__name__}: {e}); "
                      f"restart {restarts}/{self.max_restarts}")
            del state
            gc.collect()
            self._finish_inflight_save()
            time.sleep(0.1)

    def _start_step(self) -> int | None:
        """LATEST's step as rank 0 reads it, on every rank of a group of
        several: rank 0 alone writes, and every rank must restore the same
        step, or their loops run different numbers of steps and their
        collectives part."""
        step = latest_step(self.ckpt_dir)
        if dist.is_initialized() and dist.get_world_size() > 1:
            said = [step]
            dist.broadcast_object_list(said, src=0)
            step = said[0]
        return step

    def _finish_inflight_save(self):
        """Let a save the failed segment started commit before the restart
        reads LATEST (on several ranks, rank 0's write: ``wait`` is a
        collective there). A save that failed leaves the last committed
        checkpoint as it was (the write is atomic), so the restart goes on
        from that."""
        try:
            self.ckpt.wait()
        except Exception as e:  # noqa: BLE001 — the restart resumes from LATEST
            print(f"[elastic] in-flight save failed ({type(e).__name__}: {e}); "
                  f"resuming from step {latest_step(self.ckpt_dir)}")

    def maybe_save(self, state: RunState, force: bool = False):
        if self.ckpt is None:
            return
        if force or (state.step > 0 and state.step % self.save_every == 0):
            self.ckpt.save_async(
                state.step,
                {"params": state.params, "opt": state.opt_state},
                extra={"step": state.step})
