"""CUDA stream milliseconds a frame of the route's coarse pass, the span
`render.route_coarse` (`render/renderer.py:_render_chunk`: the voxel
lookup, both branches of the coarse model and the compositing glue up to
the pdf weights, once a chunk), over the traced slices of a run (the
registry's "on" bucket), per `render.frame` of those slices. None without
the span or without CUDA events."""

from benchmark.metrics.step_host_ms import host_ms


def read(r):
    return host_ms(r, ("render.route_coarse",), bucket="on", key="stream_s")
