"""Host milliseconds a train step in the span `train.backward` (the step's
`loss.backward()`, `train/system.py:TrainStep.__call__`: autograd and the
backward kernels' launches), as `step_host_ms` reads it."""

from benchmark.metrics.step_host_ms import host_ms


def read(r):
    return host_ms(r, ("train.backward",))
