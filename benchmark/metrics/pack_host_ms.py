"""Host milliseconds an edit frame in the span `mlp.pack`
(`ops/fused_mlp.py:pack_kernel_weights`, twice a frame), as `step_host_ms`
reads it."""

from benchmark.metrics.step_host_ms import host_ms


def read(r):
    return host_ms(r, ("mlp.pack",))
