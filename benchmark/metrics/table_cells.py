"""The cells of the corner tables a train step builds, (X+1)(Y+1)(Z+1) each:
the program's counter `voxel.table_cells` (`models/voxel_grid.py:
make_corner_table`; a replayed step adds its capture's count) over the
window's steps, the count of the span `train.step` in both buckets, as
`graph_step_share` counts them. None where the program keeps no such
counter."""

from benchmark.metrics.step_host_ms import totals


def read(r):
    t = totals()
    if t is None or "voxel.table_cells" not in t["counters"]:
        return None
    steps = sum(b.get("train.step", {}).get("count", 0) for b in t["spans"].values())
    if not steps:
        return None
    return t["counters"]["voxel.table_cells"] / steps
