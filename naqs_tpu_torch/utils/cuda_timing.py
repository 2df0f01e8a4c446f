"""Time functions on the CUDA card with events, several functions in turns.

Two readings per function, both in ms per call:

* held: the card first sleeps (``torch.cuda._sleep``) long enough for the
  host to enqueue every call of the run, so the calls run back to back and
  the time is the card's alone;
* unheld: the same loop with nothing queued ahead, so a call whose host
  side (Python wrapper, argument checks, launch) takes longer than its
  device work reads the host's rate instead.

A function whose unheld time exceeds its held time is bound by its host
side when it is called in a loop. Each function's hold is sized from its
warm-up: twice the time of one unheld run of its calls, and at least
HOLD_CYCLES.
"""

from __future__ import annotations

import math
import statistics

import torch

HOLD_CYCLES = 50_000_000  # ~25 ms of card sleep at the H100's ~2 GHz clock


def per_call_ms(fn, n_iter: int, hold: bool, hold_cycles: int = HOLD_CYCLES) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(hold_cycles)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def hold_ms() -> float:
    """How long the hold lasts on this card (it must exceed the enqueue)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(HOLD_CYCLES)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_in_turns(fns: dict, repeats: int, launches: int, hold: bool = True) -> dict:
    """name -> (median ms, [min, max] ms, hold ms) over `repeats` repeats of
    `launches` calls each; within a repeat the functions take turns in dict
    order. Held, a function's runs wait behind a sleep of twice its unheld
    run in the warm-up (hold ms; 0 unheld)."""
    cycles_per_ms = HOLD_CYCLES / hold_ms() if hold else 0.0
    cycles = {}
    for name, fn in fns.items():
        for _ in range(3):
            fn()
        cycles[name] = 0
        if hold:
            unheld = per_call_ms(fn, launches, hold=False) * launches
            cycles[name] = max(HOLD_CYCLES, math.ceil(2 * unheld * cycles_per_ms))
    runs = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            runs[name].append(per_call_ms(fn, launches, hold, cycles[name]))
    return {name: (statistics.median(v), [min(v), max(v)],
                   cycles[name] / cycles_per_ms if hold else 0.0)
            for name, v in runs.items()}
