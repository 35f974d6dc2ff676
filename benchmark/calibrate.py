"""Readings for the limits of a cell's comparison (`limits/<cell>.json`), on
the chip at the cell's own size, several seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --what program,control,half \
        [--out readings.jsonl]

`program`: the program's numbers against the reference, after the set-up's
checked steps (train) or a few frames (render). `control`: the reference
computed on fp8 operands in the program's place (the lower precision that
must come out as not correct). `half`: the reference trained on half of
every batch, the mean over the rest (a training cell's fault). Prints one
JSON line per seed and reading (with the leaves' norms of a train cell), and
appends them to `--out` when given."""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control,half")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", help="a file to append the JSON lines to")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    bench = harness.benchmark(ROOT)
    cell = harness.cell(args.workload, bench)
    cfg, tr = harness.config(cell["config"]), harness.traffic(cell["traffic"])
    what = args.what.split(",")
    sink = open(args.out, "a") if args.out else None
    try:
        _readings(args, cfg, tr, what, sink)
    finally:
        if sink:
            sink.close()
    return 0


def _readings(args, cfg, tr, what, sink) -> None:
    import torch

    from benchmark import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = harness.driver(tr["kind"]).Driver(cfg, tr, seed, torch.device("cuda"))
        drv.setup()  # a render or edit cell's reference needs frames rendered
        for _ in range(args.frames if drv.kind != "train" else 0):
            drv.run_unit(None)
        prog = drv.program_readings() if "program" in what else None
        drv.free()
        t_ref = time.perf_counter()
        ref = drv.reference()
        t_ref = time.perf_counter() - t_ref
        rows = []
        if prog is not None:
            rows.append(("program", drv.compare(prog, ref)))
        readings = {"program": prog}
        if "control" in what:
            readings["control"] = drv.reference("fp8")
            rows.append(("control", drv.compare(readings["control"], ref)))
        if "half" in what and drv.kind == "train":
            readings["half"] = drv.reference(half=True)
            rows.append(("half", drv.compare(readings["half"], ref)))
        for label, nums in rows:
            rec = {"cell": args.workload, "seed": seed, "reading": label, "numbers": nums,
                   "reference_s": t_ref, "seconds": time.perf_counter() - t0}
            if drv.kind == "train":
                from benchmark.compare import leaf_gaps

                got = readings[label]
                rec["grad1_leaves"] = leaf_gaps(got["grad_norms"], ref["grad_norms"])[:4]
                rec["change_leaves"] = leaf_gaps(got["change_norms"], ref["change_norms"])[:4]
                rec["losses"] = [got["losses"], ref["losses"]]
                rec["leaves"] = {"grad": [got["grad_norms"], ref["grad_norms"]],
                                 "change": [got["change_norms"], ref["change_norms"]]}
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
        del drv
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
