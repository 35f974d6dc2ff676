"""What the probe scripts share: the card's name and power limit, and the
median device time of a launch."""

from __future__ import annotations

import statistics
import subprocess

import torch

# Written before each turn of `turns_ms`: more than the H100's 50 MB L2.
FLUSH_BYTES = 256 * 2 ** 20


def require_cuda() -> torch.device:
    """The card, or an error: a time taken elsewhere says nothing about it."""
    if not torch.cuda.is_available():
        raise SystemExit("this script measures the card: CUDA is not available")
    return torch.device("cuda")


def card_line() -> str:
    """`name, power limit` as nvidia-smi gives them; printed beside every time."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def median_ms(fn, launches: int = 20, warmup: int = 2) -> float:
    """Median device ms of one call of fn over `launches` calls, each between
    its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(launches):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def turns_ms(fns, order, rounds: int, launches: int):
    """{name: [ms per call of each turn]}: `rounds` rounds of turns in `order`
    (names of `fns`, e.g. library, kernel, kernel, library), a turn `launches`
    calls of one function between two CUDA events, a buffer of FLUSH_BYTES
    written before each turn. Each function runs once first."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for fn in fns.values():
        fn()
    turns = {name: [] for name in fns}
    for _ in range(rounds):
        for name in order:
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(launches):
                fns[name]()
            b.record()
            torch.cuda.synchronize()
            turns[name].append(a.elapsed_time(b) / launches)
    return turns
