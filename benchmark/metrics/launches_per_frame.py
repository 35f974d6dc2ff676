"""The program's own launch counters over the window (the edit path's
`fused_sigma_eval` and `fused_mlp_eval` in `ops.fused_mlp.launch_counts`),
per frame."""


def read(r):
    if r.units == 0:
        return None
    return sum(r.counters.values()) / r.units
