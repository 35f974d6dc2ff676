"""The published Object-NeRF architecture as the benchmark states it: the
widths of a configuration file, the channel counts they imply, and the
parameter list under the reference's state-dict names
(zju3dv/object_nerf models/nerf_model.py; `nerf_coarse.*`, `nerf_fine.*`,
`code_library.embedding_instance.weight`,
`embedding_xyz.embedding_space_ftr.weight`). Nothing here reads the program."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class Spec:
    D: int
    W: int
    skips: Tuple[int, ...]
    inst_D: int
    inst_W: int
    inst_skips: Tuple[int, ...]
    N_freq_xyz: int
    N_freq_dir: int
    N_freq_voxel: int
    N_scn_voxel_size: int
    N_obj_voxel_size: int
    N_obj_code_length: int
    N_max_objs: int
    use_voxel_embedding: bool
    N_samples: int
    N_importance: int

    @classmethod
    def from_config(cls, model: dict) -> "Spec":
        return cls(**{f.name: (tuple(model[f.name]) if f.name.endswith("skips")
                               else model[f.name]) for f in dataclasses.fields(cls)})

    @property
    def voxel_channels(self) -> int:
        return self.N_scn_voxel_size + self.N_obj_voxel_size if self.use_voxel_embedding else 0

    @property
    def in_xyz(self) -> int:
        c = 3 * (2 * self.N_freq_xyz + 1)
        if self.use_voxel_embedding:
            c += self.N_scn_voxel_size * (2 * self.N_freq_voxel + 1)
        return c

    @property
    def in_dir(self) -> int:
        return 3 * (2 * self.N_freq_dir + 1)

    @property
    def in_obj_voxel(self) -> int:
        if not self.use_voxel_embedding:
            return 0
        return self.N_obj_voxel_size * (2 * self.N_freq_voxel + 1)

    @property
    def in_inst(self) -> int:
        return self.in_xyz + self.in_obj_voxel + self.N_obj_code_length


def branch_layers(spec: Spec, branch: str) -> List[Tuple[str, int, int]]:
    """(name, fan_in, fan_out) of one branch's linear layers, in forward order:
    the trunk, then final, sigma, dir, rgb."""
    if branch == "scene":
        depth, width, skips, c_in = spec.D, spec.W, spec.skips, spec.in_xyz
        trunk, final, sigma, dirn, rgb = ("xyz_encoding_{}.0", "xyz_encoding_final",
                                          "sigma", "dir_encoding.0", "rgb.0")
    else:
        depth, width, skips, c_in = spec.inst_D, spec.inst_W, spec.inst_skips, spec.in_inst
        trunk, final, sigma, dirn, rgb = ("instance_encoding_{}.0", "instance_encoding_final.0",
                                          "instance_sigma", "inst_dir_encoding.0", "inst_rgb.0")
    out = []
    for i in range(depth):
        fan_in = c_in if i == 0 else (width + c_in if i in skips else width)
        out.append((trunk.format(i + 1), fan_in, width))
    out += [(final, width, width), (sigma, width, 1),
            (dirn, width + spec.in_dir, width // 2), (rgb, width // 2, 3)]
    return out


def parameter_shapes(spec: Spec, n_cells: int = 0):
    """[(name, shape, init)] of the whole system: init is ("uniform", bound)
    or ("normal",). `n_cells` sizes the voxel lattice (one row per grid cell,
    X*Y*Z), whose occupied rows are the feature table."""
    out = []
    for net in ("nerf_coarse", "nerf_fine"):
        for branch in ("scene", "object"):
            for name, fan_in, fan_out in branch_layers(spec, branch):
                bound = fan_in ** -0.5
                out.append((f"{net}.{name}.weight", (fan_out, fan_in), ("uniform", bound)))
                out.append((f"{net}.{name}.bias", (fan_out,), ("uniform", bound)))
    out.append(("code_library.embedding_instance.weight",
                (spec.N_max_objs, spec.N_obj_code_length), ("normal",)))
    if spec.use_voxel_embedding:
        out.append((LATTICE, (n_cells, spec.voxel_channels), ("normal",)))
    return out


TABLE = "embedding_xyz.embedding_space_ftr.weight"
LATTICE = "voxel_lattice"  # (X*Y*Z, C): the table's rows are its occupied cells
