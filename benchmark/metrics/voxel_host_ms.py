"""Host milliseconds a train step in the voxel layer's spans
(`models/voxel_grid.py`): the corner table's build `voxel.table`, the
lookups `voxel.lookup` and the table gradient `voxel.table_grad` (on
autograd's thread, inside `train.backward`), as `step_host_ms` reads them."""

from benchmark.metrics.step_host_ms import host_ms


def read(r):
    return host_ms(r, ("voxel.table", "voxel.lookup", "voxel.table_grad"))
