"""The forward chain's share of its roofline in the traced slice of a route
window: the larger of (FLOPs / peak) and (bytes / peak bandwidth) of the
slice's route frames (`route_flops.route_frame_flops`,
`route_flops.route_chain_bytes`), over the device time of
`fwd_chain_kernel` (`ops/csrc/fused_mlp_wg.cuh`, the frame's row-3 and
row-2 launches)."""

from benchmark import route_flops


def read(r):
    if r.trace is None:
        return None
    t = r.trace.kernel_seconds(("fwd_chain_kernel",))
    if t <= 0:
        return None
    w, h = r.traffic["img_wh"]
    least = max(route_flops.route_frame_flops(r.spec, w * h) / r.peak_flops,
                route_flops.route_chain_bytes(r.spec, w * h) / r.peak_bytes)
    return 100.0 * r.trace.units * least / t
