"""The share of the window's edit chunks that rendered every ray set: the
program's counters `edit.chunks_mixed` over `edit.chunks`
(`edit/editable_renderer.py`, from the hit compaction's plan), in %."""

from benchmark.metrics.step_host_ms import totals


def read(r):
    t = totals()
    if t is None or not t["counters"].get("edit.chunks"):
        return None
    c = t["counters"]
    return 100.0 * c.get("edit.chunks_mixed", 0) / c["edit.chunks"]
