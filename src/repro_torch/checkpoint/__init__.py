"""Crash-consistent checkpoint store on the port's PM arena and P-CLHT
manifest (``store``)."""

from .store import CheckpointStore

__all__ = ["CheckpointStore"]
