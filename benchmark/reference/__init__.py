"""The plain reference of the published Object-NeRF model (float32 PyTorch,
TF32 off), written from the model's equations: the voxel grid and its
trilinear lookup (`voxel.py`), the two-branch MLP (`model.py`), sampling,
compositing and the losses (`render.py`), and the training step with Adam
(`train.py`). It imports nothing of the program and takes nothing the
program made: the benchmark hands it the same point cloud, weights, rays
and random draws it hands the program.

`Rounding` puts every matrix product's operands through one precision:
`exact` (float32) for the reference, `fp8` (e4m3, one scale per tensor)
for the control that must come out as not correct."""

import torch


def no_tf32() -> None:
    """Float32 products in float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
