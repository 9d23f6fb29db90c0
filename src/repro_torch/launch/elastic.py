"""Fault tolerance & elasticity for 1000+ node posture: the port of
``repro.launch.elastic`` (pure Python; the JAX module imports no JAX,
and this is its copy).

On a real cluster these hooks ride on the coordination service; here
they are fully implemented against a simulated worker set so the
policies — heartbeat timeout, straggler quantile detection, elastic
re-mesh, checkpoint-restart — are testable logic, not pseudo-code.

Policies:
* **Heartbeats** — every worker reports (step, walltime) each step; a
  worker silent for ``timeout_steps`` is declared dead.
* **Stragglers** — per-step times are compared to the fleet median; a
  worker slower than ``straggler_factor``× median for
  ``straggler_patience`` consecutive steps is flagged; the scheduler's
  response is re-dispatch (in our simulation: mark + exclude, which is
  also what you do on real pods by remapping the slice).
* **Elastic re-mesh** — given the dead set, pick the largest data-axis
  size that divides the survivors (model axis is fixed by the sharding
  plan); training resumes from the last committed generation, which the
  RECIPE checkpoint store guarantees is consistent no matter when the
  failure hit.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Set, Tuple


@dataclasses.dataclass
class WorkerState:
    last_step: int = -1
    last_time: float = 0.0
    step_times: List[float] = dataclasses.field(default_factory=list)
    slow_streak: int = 0
    alive: bool = True
    straggler: bool = False


class FleetMonitor:
    def __init__(self, n_workers: int, *, timeout_steps: int = 3,
                 straggler_factor: float = 2.0,
                 straggler_patience: int = 3):
        self.workers = {w: WorkerState() for w in range(n_workers)}
        self.timeout_steps = timeout_steps
        self.straggler_factor = straggler_factor
        self.straggler_patience = straggler_patience
        self.global_step = 0

    def heartbeat(self, worker: int, step: int, step_time: float) -> None:
        ws = self.workers[worker]
        ws.last_step = step
        ws.step_times.append(step_time)
        self.global_step = max(self.global_step, step)

    def sweep(self) -> Tuple[Set[int], Set[int]]:
        """Returns (dead, stragglers) after this step boundary."""
        times = [w.step_times[-1] for w in self.workers.values()
                 if w.alive and w.step_times]
        med = statistics.median(times) if times else 0.0
        dead, stragglers = set(), set()
        for wid, ws in self.workers.items():
            if not ws.alive:
                dead.add(wid)
                continue
            if ws.last_step < self.global_step - self.timeout_steps:
                ws.alive = False
                dead.add(wid)
                continue
            if ws.step_times and med > 0 and \
                    ws.step_times[-1] > self.straggler_factor * med:
                ws.slow_streak += 1
                if ws.slow_streak >= self.straggler_patience:
                    ws.straggler = True
                    stragglers.add(wid)
            else:
                ws.slow_streak = 0
        return dead, stragglers

    def kill(self, worker: int) -> None:
        self.workers[worker].alive = False


def elastic_mesh_plan(n_alive: int, model_axis: int,
                      pod_axis: int = 1) -> Optional[Tuple[int, ...]]:
    """Largest (pod, data, model) grid fitting the survivors: the model
    axis is pinned (weights are sharded that way), the data axis
    shrinks — gradient accumulation increases to keep global batch."""
    if n_alive < model_axis:
        return None
    data = n_alive // (model_axis * pod_axis)
    if data == 0:
        return None
    return (pod_axis, data, model_axis) if pod_axis > 1 else (data, model_axis)


def accumulation_for(global_batch: int, data_parallel: int,
                     per_device_batch: int) -> int:
    """Microbatch accumulation that preserves the global batch when the
    data axis shrinks after a failure."""
    denom = data_parallel * per_device_batch
    return max(1, -(-global_batch // denom))
