"""Every cell of the dry run counts one device's share on both production
meshes, on the CPU: the counterpart on the 32 x 8 and 2 x 32 x 8 meshes
(``launch.mesh.device_mesh``) of ``test_torch_dryrun.py``'s
``test_every_cell_traces_on_meta_at_reduced``, at the same cut (each
configuration's ``reduced()``, the cell's shape cut 64-fold in length
and batch).  Each step and each group's probe runs on ``meta`` under
DTensor, every model kernel charged and none launched, with FLOPs and
bytes counted.  No tolerance: nothing is compared but that the counts
are there.
"""

import dataclasses

import pytest

from repro_torch.analysis import roofline
from repro_torch.configs import all_archs, get_arch
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.launch import steps
from repro_torch.launch.mesh import device_mesh, make_production_mesh

CELLS = [(a, s) for a in all_archs() for s in SHAPES
         if shape_applicable(get_arch(a), SHAPES[s])[0]]
MESHES = {"32x8": make_production_mesh(),
          "2x32x8": make_production_mesh(multi_pod=True)}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_every_cell_counts_a_share_at_reduced(arch, shape, mesh_name):
    mesh = MESHES[mesh_name]
    full = SHAPES[shape]
    cut = dataclasses.replace(full, seq_len=max(1, full.seq_len // 64),
                              global_batch=max(1, full.global_batch // 64))
    cfg = get_arch(arch).reduced()
    if cfg.vision is not None and cut.kind != "decode":
        cut = dataclasses.replace(cut, seq_len=cfg.vision.n_patches + 8)
    with device_mesh(mesh):
        low, _ = steps.lower_cell(cfg, cut, mesh)
        costs, _ = roofline.count_costs(low.fn, *low.args)
        assert costs.flops > 0 and costs.bytes_accessed > 0 and costs.kernels
        for _, _, probe in steps.group_probes(cfg, cut, mesh):
            assert roofline.count_costs(probe.fn, *probe.args)[0].flops > 0
