"""Host milliseconds a train step in the program's own span `train.step`
(`train/system.py:TrainStep.__call__`), over the untraced steps of a traced
run's window. Every program span's totals come from the program's registry,
`object_nerf_torch/utils/trace.py`, which the window's reset zeroed: the
"off" bucket holds the spans closed while no profiler recorded (the window
outside its traced slices), and its unit span (`train.step`, `render.frame`
or `edit.frame`) counts the units. The other host readers use `host_ms`."""

UNIT_SPAN = {"train": "train.step", "render": "render.frame", "edit": "edit.frame"}


def totals():
    """The program's registry totals, or None where the program has none."""
    try:
        from object_nerf_torch.utils import trace
    except ImportError:
        return None
    return trace.totals()


def host_ms(r, names, bucket="off", key="host_s"):
    """The spans `names`' summed `key` seconds in `bucket`, in ms a unit of
    the cell's kind: host seconds, where a span that never opened adds 0,
    or with `key` = "stream_s" the CUDA stream's, where one has to have a
    reading. None without the registry or a unit in the bucket."""
    t = totals()
    if t is None:
        return None
    spans = t["spans"][bucket]
    unit = spans.get(UNIT_SPAN[r.kind])
    found = [spans[n][key] for n in names if n in spans and spans[n][key] is not None]
    if not unit or not unit["count"] or (key == "stream_s" and not found):
        return None
    return 1e3 * sum(found) / unit["count"]


def read(r):
    return host_ms(r, ("train.step",))
