"""The control: the reference computed on fp8 operands in the program's
place must come out as not correct, by the cell's limits, at the published
widths. Here on the CPU with a few rays; on the card (marked `cuda`) at the
cell's own size."""

import pytest
import torch

from benchmark import compare, harness

BENCH = harness.benchmark()


def _control(cell, device, traffic):
    w = harness.cell(cell, BENCH)
    cfg, tr = harness.config(w["config"]), {**harness.traffic(w["traffic"]), **traffic}
    drv = harness.driver(tr["kind"]).Driver(cfg, tr, 2 ** 31 + 19, device)
    drv.setup()
    for _ in range(1 if drv.kind == "render" else 0):
        drv.run_unit(drv.new_bad())
    drv.free()
    ref = drv.reference()
    ok, rows = compare.judge(drv.compare(drv.reference("fp8"), ref),
                             compare.load_limits(cell))
    return ok, rows


SMALL_TRAFFIC = {"batch": 96, "pool_rays": 4096, "views": 4, "img_wh": [40, 30],
                 "warmup_steps": 0, "chunk": 400}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_fp8_control_is_not_correct(cell):
    ok, rows = _control(cell, torch.device("cpu"), SMALL_TRAFFIC)
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_fp8_control_is_not_correct_at_the_cells_size(cell, cuda_device):
    ok, rows = _control(cell, cuda_device, {})
    assert not ok, rows
