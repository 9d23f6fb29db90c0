"""``repro_torch.api`` — the public facade of the PyTorch port::

    from repro_torch.api import open_index, Plan

    s = open_index("clht")                 # on the card
    s = open_index("clht", device="cpu")   # plain PyTorch versions
    s.put(1, 10)
    with s.pipeline() as p:
        p.put(2, 20)
        h = p.get(2)
        print(h.value)          # drains the pipeline: one plan

Everything routes through operation plans and the conflict-wave
scheduler (``core/plan.py``).
"""

from ..core import Op, OpKind, Plan, PlanResult, Wave, schedule_waves
from .session import OpHandle, Pipeline, Session, open_index

__all__ = ["Op", "OpHandle", "OpKind", "Pipeline", "Plan", "PlanResult",
           "Session", "Wave", "open_index", "schedule_waves"]
