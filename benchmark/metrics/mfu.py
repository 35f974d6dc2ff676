"""A step's or a frame's model FLOPs (`flops.train_step_flops`,
`flops.render_frame_flops`) over the untraced part of a traced run's window,
as a share of the card's dense bf16 peak."""


def read(r):
    if not r.untraced or r.untraced[0] == 0:
        return None
    units, seconds = r.untraced
    return 100.0 * units * r.unit_flops / seconds / r.peak_flops
