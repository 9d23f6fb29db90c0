"""The dry run's meshes: the port of ``repro.launch.mesh``.

A ``MeshSpec`` names axes and their sizes: ``.shape`` is the dict of
axis name -> size that the sharding rules read (the JAX rules take it
too), ``.size`` the device count.  ``device_mesh(spec)`` makes it a
``DeviceMesh`` over a ``fake`` process group of ``spec.size`` ranks of
which this process is rank 0, the counterpart of the JAX dry run's
fake host devices: DTensors over it hold rank 0's shards, DTensor's
sharding propagation partitions the program, and the collectives it
inserts are recorded and move nothing.  One process, with one card or
none, runs one device's share of a production mesh; placing the other
shards on other cards waits for two or more cards (ROADMAP item 5b).

* ``make_smoke_mesh()``: (1, 1) over ("data", "model"), the one card;
* ``make_production_mesh(multi_pod)``: the JAX package's 256 and 512
  devices as an H100 deployment, ("data", "model") = (32, 8) and
  ("pod", "data", "model") = (2, 32, 8).  The model axis is 8 because
  one HGX H100 node joins 8 cards by NVLink (450 GB/s each way), which
  tensor parallelism needs; the data axes span nodes.  The JAX package's
  16 x 16 is a TPU v5e pod's torus and has no counterpart here.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple


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


@contextlib.contextmanager
def device_mesh(spec: MeshSpec, device: str = "meta") -> Iterator:
    """A ``DeviceMesh`` of ``spec``'s axes over a ``fake`` process group
    of ``spec.size`` ranks, this process rank 0; the group is destroyed on
    exit, so one process can count one mesh after another.  ``device``
    is where the DTensors' shards live: ``"meta"`` (a count; the mesh is a
    CPU mesh holding meta shards), ``"cuda"`` (rank 0's shards on the
    card, which ``init_device_mesh`` selects: device 0) or ``"cpu"``.
    The ``fake`` backend registers itself when
    ``torch.testing._internal.distributed.fake_pg`` is imported."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    from torch.distributed.device_mesh import init_device_mesh

    from ..analysis import roofline

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", rank=0, world_size=spec.size,
                            store=dist.HashStore())
    try:
        mesh = init_device_mesh("cpu" if device == "meta" else device,
                                spec.sizes, mesh_dim_names=spec.axis_names)
        roofline.name_groups({mesh.get_group(ax).group_name: ax
                              for ax in spec.axis_names})
        _CURRENT.append((spec, mesh))
        yield mesh
    finally:
        if _CURRENT:
            _CURRENT.pop()
        roofline.name_groups({})
        dist.destroy_process_group()


_CURRENT: list = []  # (MeshSpec, DeviceMesh) of the open device_mesh


def current(spec: MeshSpec):
    """The ``DeviceMesh`` of the ``device_mesh(spec)`` that is open."""
    if not _CURRENT or _CURRENT[-1][0] != spec:
        raise RuntimeError(f"the {spec.name} mesh is a DeviceMesh only "
                           f"inside device_mesh(spec)")
    return _CURRENT[-1][1]


__all__ = ["MeshSpec", "current", "device_mesh", "make_production_mesh",
           "make_smoke_mesh"]
