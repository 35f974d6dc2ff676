"""The program's own launch counters over the window, per step:
`ops.fused_mlp.launch_counts` (the forward and backward kernels),
`ops.gather.launch_counts` (row gathers) and
`models.voxel_grid.build_counts` (corner-table builds)."""


def read(r):
    if r.units == 0:
        return None
    return sum(r.counters.values()) / r.units
