"""CUDA stream milliseconds a frame of the edit path's cross-set glue, the
span `render.multi_joint` (`render/multi.py:render_multi_fused_eval`: the
joint coarse weights, their unsort and the importance draws of every ray
set; the final joint composite; twice a chunk), over the traced slices of a
run (the registry's "on" bucket), per `edit.frame` of those slices. None
without the span or without CUDA events."""

from benchmark.metrics.step_host_ms import host_ms


def read(r):
    return host_ms(r, ("render.multi_joint",), bucket="on", key="stream_s")
