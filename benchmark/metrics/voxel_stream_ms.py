"""CUDA stream milliseconds a frame of the voxel layer's spans
`voxel.table` and `voxel.lookup` (`models/voxel_grid.py`): the elapsed time
of the event pair each records on the current stream while a profiler
records, so over the traced slices of a run (the registry's "on" bucket),
per `render.frame` of those slices. None without CUDA events."""

from benchmark.metrics.step_host_ms import host_ms


def read(r):
    return host_ms(r, ("voxel.table", "voxel.lookup"), bucket="on", key="stream_s")
