"""The dry run's meshes: the port of ``repro.launch.mesh``.

A ``MeshSpec`` names axes and their sizes and nothing more: ``.shape``
is the dict of axis name -> size that the sharding rules read (the JAX
rules take it too), ``.size`` the device count.  It places nothing
across cards; running a program over such a mesh waits for a
partitioner and two or more cards (ROADMAP item 5).

* ``make_smoke_mesh()``: (1, 1) over ("data", "model"), the one card;
* ``make_production_mesh(multi_pod)``: the JAX package's 256 and 512
  devices as an H100 deployment, ("data", "model") = (32, 8) and
  ("pod", "data", "model") = (2, 32, 8).  The model axis is 8 because
  one HGX H100 node joins 8 cards by NVLink (450 GB/s each way), which
  tensor parallelism needs; the data axes span nodes.  The JAX package's
  16 x 16 is a TPU v5e pod's torus and has no counterpart here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class MeshSpec:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        """The sizes joined by "x": "1x1", "32x8", "2x32x8"."""
        return "x".join(map(str, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 32, 8))
    return MeshSpec(("data", "model"), (32, 8))


def make_smoke_mesh() -> MeshSpec:
    """The one card, with the production axis names."""
    return MeshSpec(("data", "model"), (1, 1))


__all__ = ["MeshSpec", "make_production_mesh", "make_smoke_mesh"]
