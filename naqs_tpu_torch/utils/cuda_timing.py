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
HOLD_CYCLES. A caller can have every held run checked: an unheld run of the
same calls right after it (what the host's enqueue takes, at most) must be
shorter than its hold; a run whose unheld partner outlasted the hold (a stall
of the host in either) is run again with twice the hold, and the caller gets
the runs that stayed so.
"""

from __future__ import annotations

import math
import statistics

import torch

HOLD_CYCLES = 50_000_000  # ~25 ms of card sleep at the H100's ~2 GHz clock
HOLD_TRIES = 4            # holds a checked function may take: its first and 3 doublings


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


def time_in_turns(fns: dict, repeats: int, launches: int, hold: bool = True,
                  uncovered: dict | None = None) -> dict:
    """name -> (median ms, [min, max] ms, hold ms) over `repeats` repeats of
    `launches` calls each; within a repeat the functions take turns in dict
    order. Held, a function's runs wait behind a sleep of twice its unheld
    run in the warm-up (hold ms: the last hold it needed). With `uncovered`
    (a dict), each held run is followed by an unheld run of the same calls;
    where that took as long as the hold, the pair is run again with twice the
    hold, which the function's later runs keep (at most HOLD_TRIES - 1
    doublings a function), and `uncovered` gets, by name, the runs whose
    unheld partner still outlasted the hold (0 where none did)."""
    cycles_per_ms = HOLD_CYCLES / hold_ms() if hold else 0.0
    cycles, doublings = {}, dict.fromkeys(fns, 0)
    for name, fn in fns.items():
        for _ in range(3):
            fn()
        cycles[name] = 0
        if hold:
            unheld = per_call_ms(fn, launches, hold=False) * launches
            cycles[name] = max(HOLD_CYCLES, math.ceil(2 * unheld * cycles_per_ms))
    check = hold and uncovered is not None
    runs = {name: [] for name in fns}
    missed = dict.fromkeys(fns, 0)
    for _ in range(repeats):
        for name, fn in fns.items():
            while True:
                ms = per_call_ms(fn, launches, hold, cycles[name])
                if not check:
                    break
                enqueue_ms = per_call_ms(fn, launches, hold=False) * launches
                if enqueue_ms * cycles_per_ms < cycles[name]:
                    break
                if doublings[name] == HOLD_TRIES - 1:
                    missed[name] += 1
                    break
                cycles[name] *= 2
                doublings[name] += 1
            runs[name].append(ms)
    if uncovered is not None:
        uncovered.update(missed)
    return {name: (statistics.median(v), [min(v), max(v)],
                   cycles[name] / cycles_per_ms if hold else 0.0)
            for name, v in runs.items()}
