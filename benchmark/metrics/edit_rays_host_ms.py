"""Host milliseconds an edit frame in the edit path's host spans before the
render (`edit/editable_renderer.py`): the ray sets and box intersections
`edit.rays`, the hit compaction `edit.compact` and the uploads
`edit.upload`, as `step_host_ms` reads them."""

from benchmark.metrics.step_host_ms import host_ms


def read(r):
    return host_ms(r, ("edit.rays", "edit.compact", "edit.upload"))
