"""The backward's share of its roofline in the traced slice: the larger of
(FLOPs / peak) and (bytes / peak bandwidth) of the slice's steps
(`flops.train_bwd_flops`, `flops.train_bwd_bytes`), over the device time of
`mlp_bwd_kernel`, `wgrad_kernel` and `reduce_segments_kernel`
(`ops/csrc/fused_mlp_train.cu`)."""

from benchmark import flops

KERNELS = ("mlp_bwd_kernel", "wgrad_kernel", "reduce_segments_kernel")


def read(r):
    if r.trace is None:
        return None
    t = r.trace.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    batch = int(r.traffic["batch"])
    least = max(flops.train_bwd_flops(r.spec, batch) / r.peak_flops,
                flops.train_bwd_bytes(r.spec, batch) / r.peak_bytes)
    return 100.0 * r.trace.units * least / t
