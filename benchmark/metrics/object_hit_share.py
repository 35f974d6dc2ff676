"""The share of the object ray sets' rays that hit their object's box, in %:
the program's counters `edit.object_hits` (rays of the object sets with
near < far) over the object sets' rays, (`edit.sets` - frames) x the
pixels of a frame (`edit/editable_renderer.py`, counted on the host). It
says how much object work the traffic asks for. None where the program
keeps no such counter."""

from benchmark.metrics.step_host_ms import totals


def read(r):
    t = totals()
    if t is None or "edit.object_hits" not in t["counters"]:
        return None
    frames = sum(b.get("edit.frame", {}).get("count", 0) for b in t["spans"].values())
    w, h = r.traffic["img_wh"]
    rays = (t["counters"].get("edit.sets", 0) - frames) * w * h
    if rays <= 0:
        return None
    return 100.0 * t["counters"]["edit.object_hits"] / rays
