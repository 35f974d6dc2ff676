"""Host milliseconds an edit frame in the span `edit.fetch`
(`edit/editable_renderer.py`: the scatter back to pixel order and the maps'
copy to the host, which waits for the frame's device work), as
`step_host_ms` reads it."""

from benchmark.metrics.step_host_ms import host_ms


def read(r):
    return host_ms(r, ("edit.fetch",))
