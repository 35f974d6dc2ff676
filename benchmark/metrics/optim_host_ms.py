"""Host milliseconds a train step in the span `train.optim` (the learning
rate, the gradients cleared and Adam's step, `train/system.py:
TrainStep.__call__`), as `step_host_ms` reads it."""

from benchmark.metrics.step_host_ms import host_ms


def read(r):
    return host_ms(r, ("train.optim",))
