"""object_nerf_torch: the PyTorch/CUDA port of object-nerf-tpu.

A second package beside `object_nerf_tpu`, which stays the reference. The
module layout and names follow the JAX package so each counterpart is easy
to find; inside, the code is ordinary PyTorch (`nn.Module`s, functions on
tensors, an explicit `device`, `torch.Generator` for randomness). Every
Pallas kernel of the JAX package has a hand-written CUDA C++ counterpart for
Hopper under `ops/csrc/`, each behind a wrapper in `ops/` with its plain
PyTorch version beside it.

Entry points run on `cuda` unless the caller passes `device="cpu"`; when
CUDA is absent they raise instead of carrying on on the CPU.

This module imports nothing heavy: `torch` is imported by the submodules.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
