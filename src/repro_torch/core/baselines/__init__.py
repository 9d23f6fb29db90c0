"""Hand-crafted PM index baselines the paper evaluates against (§7)."""

from .fastfair import FastFair
from .cceh import CCEH, StallError
from .level_hashing import LevelHashing

__all__ = ["FastFair", "CCEH", "StallError", "LevelHashing"]
