"""The share of the traced device slice in which the card ran no kernel,
copy or set: 1 - (union of their intervals) / (the slice), from a profile
of CUDA activity alone. In the edit cell the gaps are the host work of
`edit/editable_renderer.py` and `render/multi.py` between launches."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
