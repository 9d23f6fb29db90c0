"""Each parameter's gradient placed as its parameter, on the CPU over a
``fake`` process group (``launch.mesh.device_mesh``, ``meta`` shards).

Under XLA the JAX package's train step gives every gradient its
parameter's sharding (``repro.launch.steps``).  DTensor places each op's
output alone, so the port's model code places the activations that
would carry a gradient astray (``models/common.py``): InternVL's
projected patches take the text's placements before the concatenation
(F4), attention's output reaches the row-parallel ``wo`` sharded on its
rows where the heads fall back to replication (F5, ``row_matmul``), and
Mamba's ``w_in`` product passes its gradient back at its own placements
(F5, ``keep_grad``).  Here the loss of a train cell runs forward and
backward under ``spmd`` and every gradient must have its parameter's
local shape and placements, partial sums where the parameter is
replicated aside (AdamW's step reduces them):

* every architecture's ``reduced()`` train cell on a (2, 4) mesh, where
  a single kv head (and Qwen2's 4 of 14 heads' rule) does not divide
  "model";
* the full width's ``train_4k`` on 32 x 8 for the five architectures
  whose gradients went astray there (InternVL2-76B, and the heads or
  Mamba fallbacks of Qwen2-0.5B, MiniCPM-2B, StarCoder2-15B and Jamba);
* InternVL2-76B's ``train_4k`` share fits 80 GB by the dry run on both
  production meshes.
"""

import pytest
from torch.distributed.tensor import Replicate

from repro_torch.configs import SHAPES, ShapeCfg, all_archs, get_arch
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import (MeshSpec, device_mesh,
                                     make_production_mesh)

MESH = MeshSpec(("data", "model"), (2, 4))
SMALL = ShapeCfg("train_small", "train", 64, 4)
FULL_WIDTH = ["internvl2-76b", "qwen2-0.5b", "minicpm-2b", "starcoder2-15b",
              "jamba-1.5-large-398b"]


def misplaced(cfg, shape, mesh):
    """The parameters of ``cfg``'s train cell on ``mesh`` whose gradient
    after one loss and backward is not placed as the parameter:
    [(name, gradient's local shape and placements, parameter's)].  A
    gradient may hold partial sums where its parameter is replicated
    (over the data axes, and over "model" for a norm's weight, whose
    input's gradient comes from column-parallel products): AdamW's step
    reduces them, and they hold no more than the parameter's shard."""
    with device_mesh(mesh):
        low, model = steps.lower_cell(cfg, shape, mesh)
        model.requires_grad_(True)
        steps.spmd(lambda batch: model.loss(batch).backward())(low.args[0])
        out = []
        for name, p in model.named_parameters():
            g = p.grad
            have = (tuple(g.to_local().shape), g.placements)
            want = (tuple(p.to_local().shape), p.placements)
            if have[0] != want[0] or not all(
                    a == b or a.is_partial() and b == Replicate()
                    for a, b in zip(have[1], want[1])):
                out.append((name, have, want))
    return out


@pytest.mark.parametrize("arch", all_archs())
def test_reduced_gradients_are_placed_as_their_parameters(arch):
    bad = misplaced(get_arch(arch).reduced(), SMALL, MESH)
    assert bad == [], bad[:4]


@pytest.mark.parametrize("arch", FULL_WIDTH)
def test_full_width_gradients_are_placed_as_their_parameters(arch):
    bad = misplaced(get_arch(arch), SHAPES["train_4k"],
                    make_production_mesh())
    assert bad == [], (len(bad), bad[:4])


def test_internvl_train_share_fits_on_both_meshes(tmp_path):
    """The count (argument + temp bytes a device) under 80 GB on 32 x 8
    and 2 x 32 x 8; with the residual stream sharded on D it read 156.5
    and 115.9 GB."""
    for mesh in (make_production_mesh(),
                 make_production_mesh(multi_pod=True)):
        rec = dryrun.run_cell("internvl2-76b", "train_4k", mesh,
                              out_dir=str(tmp_path), probes=False)
        held = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
        assert rec["fits_80gb"] and held < 80e9, (mesh.name, held)
