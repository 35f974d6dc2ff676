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
    embedding_xyz.embedding_space_ftr.weight    (voxel feature table)
    embedding_xyz.voxel_*                       (voxel grid buffers)

The JAX package stores weights `(in, out)`; a torch `Linear` stores them
`(out, in)`, so every weight is transposed. The voxel feature table keeps its
layout. A voxel grid's topology is no part of a state dict: the reference
keeps it in registered buffers (`embedding_xyz.voxel_*`), the port's own
checkpoints beside the state dict (`voxel_topo`, `voxel_static`);
`load_reference_ckpt(..., with_voxel=True)` returns either form and
`voxel_grid_from_ckpt` turns it into the port's grid. Loading the JAX
package's Orbax checkpoints is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_SCENE = (("trunk", "xyz_encoding_{}.0"), ("final", "xyz_encoding_final"),
          ("sigma", "sigma"), ("dir", "dir_encoding.0"), ("rgb", "rgb.0"))
_OBJECT = (("trunk", "instance_encoding_{}.0"), ("final", "instance_encoding_final.0"),
           ("sigma", "instance_sigma"), ("dir", "inst_dir_encoding.0"),
           ("rgb", "inst_rgb.0"))
_MODULES = ("nerf_coarse", "nerf_fine", "code_library")
_VOXEL_TABLE = "embedding_xyz.embedding_space_ftr.weight"
_VOXEL_BUFFERS = ("voxel_size", "bounds", "voxel_offset", "voxel_shape", "voxel_occupancy",
                  "voxel_idx_map")


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
    if "voxel_features" in params:
        sd[_VOXEL_TABLE] = _tensor(params["voxel_features"])
    return sd


def voxel_from_jax(features, topo: Mapping[str, Any], static: Mapping[str, Any],
                   device="cpu"):
    """A JAX package voxel grid -> the port's (features, VoxelTopology,
    VoxelStatic) on `device`: `features` and the topology's fields as numpy
    arrays (`topo._asdict()`), the static's fields as a mapping (`shape`,
    `channels`, `n_freq_voxel`, `n_max_voxels`)."""
    from ..models.voxel_grid import VoxelStatic, topology_from_dict

    features = _tensor(features).to(device)
    vtopo = topology_from_dict({k: np.asarray(v) for k, v in topo.items()},
                               capacity=int(features.shape[0]), device=device)
    vstatic = VoxelStatic(shape=tuple(int(x) for x in static["shape"]),
                          channels=int(static["channels"]),
                          n_freq_voxel=int(static["n_freq_voxel"]),
                          n_max_voxels=int(static["n_max_voxels"]))
    return features, vtopo, vstatic


def voxel_grid_from_ckpt(voxel: Mapping[str, Any], n_freq_voxel: int, device="cpu"):
    """The `voxel` dict of `load_reference_ckpt(..., with_voxel=True)` -> the
    port's (features, VoxelTopology, VoxelStatic) on `device`."""
    from ..models.voxel_grid import from_torch_buffers

    if "topo" in voxel:  # one of the port's own checkpoints
        return voxel_from_jax(voxel["features"], voxel["topo"], voxel["static"], device)
    return from_torch_buffers(voxel, n_freq_voxel, device)


def from_jax_grads(grads: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX gradient pytree (the param pytree's structure, leaves as numpy
    arrays) -> {the port's parameter name: gradient}. A gradient has its
    parameter's layout, so this is `from_jax_params`."""
    return from_jax_params(grads)


def load_reference_ckpt(path, prefixes_to_ignore=("loss",), with_voxel: bool = False):
    """A reference Lightning `.ckpt` (or a bare state dict saved with
    `torch.save`, or one of the port's own checkpoints) -> the port's state
    dict, on the CPU. `path` may also be the already unpickled checkpoint.

    With `with_voxel` returns `(state_dict, voxel)`: `voxel` is None for a
    classical checkpoint; for a voxel-conditioned one it holds the feature
    table and the grid, either the reference's `embedding_xyz.*` buffers
    (`features`, `voxel_size`, `voxel_offset`, `voxel_shape`,
    `voxel_occupancy`, `voxel_idx_map`, as
    `object_nerf_tpu/train/torch_convert.py:85-104` returns them) or the port's
    (`features`, `topo`, `static`); `voxel_grid_from_ckpt` takes both. The
    state dict then carries the table under its reference name too. Without
    `with_voxel` a checkpoint that holds a grid raises: its caller would drop
    the grid.

    The file is unpickled in full (Lightning checkpoints carry more than
    tensors): load only checkpoints from a trusted source."""
    ckpt = path if isinstance(path, Mapping) else \
        torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items()
          if not any(k.startswith(p) for p in prefixes_to_ignore)}
    voxel: Optional[Dict[str, Any]] = None
    if _VOXEL_TABLE in sd:
        voxel = {"features": torch.as_tensor(sd[_VOXEL_TABLE]).float()}
        if isinstance(ckpt, dict) and ckpt.get("voxel_topo") is not None:
            voxel.update(topo=ckpt["voxel_topo"], static=ckpt["voxel_static"])
        else:
            for name in _VOXEL_BUFFERS:
                if f"embedding_xyz.{name}" in sd:
                    voxel[name] = torch.as_tensor(sd[f"embedding_xyz.{name}"])
    if voxel is not None and not with_voxel:
        raise ValueError(
            "checkpoint holds a voxel feature grid (embedding_xyz.*): load it with "
            "with_voxel=True and build the grid with voxel_grid_from_ckpt")
    sd = {k: v for k, v in sd.items()
          if not k.startswith("embedding_xyz.") or k == _VOXEL_TABLE}
    unknown = sorted(k for k in sd if k.split(".", 1)[0] not in _MODULES + ("embedding_xyz",))
    if unknown:
        raise ValueError(f"unexpected checkpoint entries: {unknown[:5]}")
    sd = {k: torch.as_tensor(v).float() for k, v in sd.items()}
    return (sd, voxel) if with_voxel else sd
