"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in `BENCHMARK.json`. The run makes its
inputs and weights from the seed, builds the program (the PyTorch and CUDA
port, `object_nerf_torch`) and warms every shape up (`setup_s`), measures for
`--seconds`, then compares what the timed path produced with the plain
reference (`correct`). With `--trace 1` it profiles two slices of the
window and prints the per-layer metrics instead of the end-to-end ones. The last
line of standard output is one JSON object; the numbers compared, each with
its limit, are the last lines of standard error and the last key of that
object. It exits non-zero, printing no result, without a CUDA card (or
with fewer than the cell asks for), without the program beside it, or
when JAX or the JAX package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# a traced run profiles two slices of TRACE_SECONDS each, from TRACE_AT of its window
TRACE_AT, TRACE_SECONDS = 0.4, 2.0


def _fail(code: int, msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return code


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None, overrides=None):
    """Run the cell; returns (exit code, result line or None). `device` and
    `overrides` ({"config": {...}, "traffic": {...}} merged into the cell's
    files) serve the tests, which run on the CPU at a small size."""
    import torch

    from benchmark import common, compare, flops, harness

    bench = harness.benchmark(ROOT)
    cell = harness.cell(name, bench)
    cfg = harness.config(cell["config"])
    tr = harness.traffic(cell["traffic"])
    for key, extra in (overrides or {}).items():
        target = cfg if key == "config" else tr
        for k, v in extra.items():
            if isinstance(v, dict):
                target[k] = {**target.get(k, {}), **v}
            else:
                target[k] = v
    dev = torch.device(device or "cuda")
    drv = harness.driver(tr["kind"]).Driver(cfg, tr, seed, dev)
    drv.setup()
    setup_s = time.perf_counter() - T_START

    drv.reset_counters()
    bad = drv.new_bad()
    units, reading_trace, untraced = 0, None, None
    slice_at = TRACE_AT * seconds
    harness.SPAN_S.clear()
    host0 = _host_clocks()
    t0 = time.perf_counter()
    while True:
        if trace and reading_trace is None and time.perf_counter() - t0 >= slice_at:
            _sync(dev)
            untraced = (units, time.perf_counter() - t0)
            reading_trace, n = _traced_slices(drv, bad, TRACE_SECONDS, dev, untraced)
            units += n
        drv.run_unit(bad)
        units += 1
        if time.perf_counter() - t0 >= seconds and (reading_trace is not None or not trace):
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    host = [b - a for a, b in zip(host0, _host_clocks())]
    counters = drv.counters()
    failed = drv.failed(bad)
    device_info = common.device_info(dev)
    found = harness.forbidden_modules()
    if found:
        return _fail(5, f"JAX or the JAX package was loaded: {', '.join(found)}"), None

    prog = drv.program_readings()
    drv.free()
    ref = drv.reference()
    numbers = drv.compare(prog, ref)
    correct, rows = compare.judge(numbers, compare.load_limits(name))

    metrics = {}
    if dev.type == "cuda":
        peak_flops, peak_bytes = flops.peaks(device_info["kind"])
    else:
        peak_flops, peak_bytes = float("nan"), float("nan")
    if not trace:
        own = {"setup_s": setup_s, **drv.end_to_end(units, window_s)}
        for m in harness.cell_metrics(bench, name, traced=False):
            if m["name"] in own:
                metrics[m["name"]] = (own[m["name"]], m["unit"])
        breakdown = None
    else:
        reading = harness.Reading(
            kind=drv.kind, spec=drv.spec, traffic=tr, units=units, window_s=window_s,
            unit_flops=drv.unit_flops(), peak_flops=peak_flops, peak_bytes=peak_bytes,
            counters=counters, untraced=untraced, trace=reading_trace)
        for m in harness.cell_metrics(bench, name, traced=True):
            v = harness.metric_reader(m["name"])(reading)
            if v is not None and v == v:  # a CPU run has no peaks: nan
                metrics[m["name"]] = (v, m["unit"])
        device_info["busy_s"] = reading_trace.busy_s
        device_info["window_s"] = reading_trace.window_s
        breakdown = {"device_ops": harness.top(reading_trace.kernel_s),
                     "idle_gaps": harness.top(reading_trace.idle)}
    print(f"{name}: {units} {drv.kind} units in {window_s:.3f} s, set-up {setup_s:.3f} s, "
          f"{common.power_limit() if dev.type == 'cuda' else 'cpu'}; over the window the "
          f"main thread ran {host[0]:.3f} s on a core, the process {host[1]:.3f} s, "
          f"{host[2]} involuntary context switches; host ms a unit by span: " + ", ".join(
              f"{k} {1e3 * v / units:.3f}" for k, v in sorted(harness.SPAN_S.items())),
          file=sys.stderr)
    for k in sorted(set(numbers) - {k for k, _, _ in rows}):
        print(f"reading {k} {numbers[k]:.6g}, not compared", file=sys.stderr)
    for k, v, lim in rows:
        print(f"compared {k} {v:.6g} limit {lim}", file=sys.stderr)
    line = harness.result_line(correct, units, failed, metrics, device_info, rows, breakdown)
    return 0, line


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_clocks():
    """(main thread CPU seconds, process CPU seconds, involuntary context
    switches): where the host-bound window's time went on the host."""
    import resource

    return (time.thread_time(), time.process_time(),
            resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw)


def _profile(drv, bad, seconds: float, dev, activities, path: str):
    """Run whole units for `seconds` under a profiler of `activities`, from
    an idle device to a synchronise; export the trace to `path`. Returns
    (units, seconds on the host clock)."""
    from torch.profiler import profile, record_function

    n = 0
    with profile(activities=activities) as prof:
        with record_function("bench.window"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds or n == 0:
                drv.run_unit(bad)
                n += 1
            _sync(dev)
            window = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    return n, window


def _traced_slices(drv, bad, seconds: float, dev, untraced):
    """Two profiled slices of the window, `seconds` each. The first records
    CUDA activity alone: the device's busy time and the kernels' times, over
    the slice on the host clock (every launch of it follows its start, and it
    ends in a synchronise). The second adds the host's operations, which
    slow a host-bound step, and serves only to name what the host did in each
    idle gap. Each trace goes under the run's TMPDIR and is deleted once
    reduced."""
    from torch.profiler import ProfilerActivity

    from benchmark import harness

    cuda = [ProfilerActivity.CUDA] if dev.type == "cuda" else []
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "device.json")
        n_dev, w_dev = _profile(drv, bad, seconds, dev, cuda or [ProfilerActivity.CPU], path)
        size = os.path.getsize(path)
        busy_s, kernel_s = harness.device_time(path)
        os.remove(path)
        path = os.path.join(tmp, "host.json")
        n_host, w_host = _profile(drv, bad, seconds, dev, [ProfilerActivity.CPU] + cuda, path)
        size += os.path.getsize(path)
        idle = harness.idle_gaps(path, "bench.window")
    units, secs = untraced
    print(f"traced: {units / secs if secs else 0.0:.3f} units/s untraced before the slices, "
          f"{n_dev / w_dev:.3f} under the CUDA-only profile ({n_dev} in {w_dev:.3f} s), "
          f"{n_host / w_host:.3f} under the host and CUDA profile ({n_host} in {w_host:.3f} s); "
          f"traces {size / 2**20:.1f} MiB, slices, export and reduction "
          f"{time.perf_counter() - t_start:.2f} s", file=sys.stderr)
    return harness.Trace(w_dev, busy_s, n_dev, kernel_s, idle), n_dev + n_host


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "object_nerf_torch")):
        return _fail(2, f"the program (object_nerf_torch) is not beside {HERE}")
    sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark import harness

    cell = harness.cell(args.workload, harness.benchmark(ROOT))
    threads = harness.traffic(cell["traffic"]).get("host_threads")
    if threads:  # the host's thread pools, fixed before numpy and torch start them
        for key in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ[key] = str(int(threads))
    import torch

    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        return _fail(3, f"the cell needs {need} CUDA card(s); "
                        f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    code, line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if line is not None:
        sys.stderr.flush()
        print(line, flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
