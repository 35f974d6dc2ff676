"""The weight bridge: JAX param pytrees and reference checkpoints -> the
port's state dict.

The port's modules use the reference state-dict schema
(`object_nerf_tpu/train/torch_convert.py:1-24`):

    nerf_coarse.xyz_encoding_1.0.weight        # Sequential(Linear, act) -> .0
    nerf_coarse.xyz_encoding_final.weight
    nerf_coarse.sigma.weight
    nerf_coarse.dir_encoding.0.weight
    nerf_coarse.rgb.0.weight                   # Sequential(Linear, Sigmoid)
    nerf_coarse.instance_encoding_1.0.weight
    nerf_coarse.instance_encoding_final.0.weight
    nerf_coarse.instance_sigma.weight
    nerf_coarse.inst_dir_encoding.0.weight
    nerf_coarse.inst_rgb.0.weight
    nerf_fine.*                                 (same layout)
    code_library.embedding_instance.weight

The JAX package stores weights `(in, out)`; a torch `Linear` stores them
`(out, in)`, so every weight is transposed. Loading the JAX package's Orbax
checkpoints and the reference's voxel buffers comes with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_SCENE = (("trunk", "xyz_encoding_{}.0"), ("final", "xyz_encoding_final"),
          ("sigma", "sigma"), ("dir", "dir_encoding.0"), ("rgb", "rgb.0"))
_OBJECT = (("trunk", "instance_encoding_{}.0"), ("final", "instance_encoding_final.0"),
           ("sigma", "instance_sigma"), ("dir", "inst_dir_encoding.0"),
           ("rgb", "inst_rgb.0"))
_MODULES = ("nerf_coarse", "nerf_fine", "code_library")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _branch(sd: Dict[str, torch.Tensor], prefix: str, branch: Mapping[str, Any],
            names) -> None:
    for key, name in names:
        layers = branch[key] if key == "trunk" else [branch[key]]
        for i, layer in enumerate(layers):
            base = f"{prefix}.{name.format(i + 1)}"
            sd[f"{base}.weight"] = _tensor(layer["w"]).t().contiguous()
            sd[f"{base}.bias"] = _tensor(layer["b"])


def from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's param pytree, its leaves as numpy arrays
    (``{"coarse"|"fine": {"scene"|"object": {...}}, "code_library"}``),
    -> the port's state dict (reference key names, float32 CPU tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    for typ in ("coarse", "fine"):
        if typ in params:
            _branch(sd, f"nerf_{typ}", params[typ]["scene"], _SCENE)
            _branch(sd, f"nerf_{typ}", params[typ]["object"], _OBJECT)
    if "code_library" in params:
        sd["code_library.embedding_instance.weight"] = _tensor(params["code_library"])
    return sd


def from_jax_grads(grads: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX gradient pytree (the param pytree's structure, leaves as numpy
    arrays) -> {the port's parameter name: gradient}. A gradient has its
    parameter's layout, so this is `from_jax_params`."""
    return from_jax_params(grads)


def load_reference_ckpt(path, prefixes_to_ignore=("loss",)) -> Dict[str, torch.Tensor]:
    """A reference Lightning `.ckpt` (or a bare state dict saved with
    `torch.save`) -> the port's state dict, on the CPU.

    The file is unpickled in full (Lightning checkpoints carry more than
    tensors): load only checkpoints from a trusted source."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items()
          if not any(k.startswith(p) for p in prefixes_to_ignore)}
    if any(k.startswith("embedding_xyz.") for k in sd):
        raise NotImplementedError(
            "checkpoint holds a voxel feature grid (embedding_xyz.*): voxel "
            "conditioning is not ported yet")
    unknown = sorted(k for k in sd if k.split(".", 1)[0] not in _MODULES)
    if unknown:
        raise ValueError(f"unexpected checkpoint entries: {unknown[:5]}")
    return {k: torch.as_tensor(v).float() for k, v in sd.items()}
