"""Optimizer on the port: AdamW with fp32 master weights and moments
(``adamw``) and the learning-rate schedules (``schedules``: WSD for
MiniCPM, cosine otherwise)."""

from . import adamw, schedules
from .adamw import AdamWState

__all__ = ["adamw", "schedules", "AdamWState"]
