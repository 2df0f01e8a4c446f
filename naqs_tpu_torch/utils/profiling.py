"""Tracing, timing and metrics-log helpers.

Port of `naqs_tpu/utils/profiling.py`: the metric channels (`LogKey`), a
wall-clock timer (`timed`), the card's memory statistics
(`device_memory_stats`, from `torch.cuda.memory_stats`), a torch.profiler
trace of a block (`profile_trace`, written as a Chrome trace) and
`save_log`, which writes a metrics log as JSONL lines equal to the JAX
package's (and a pandas pickle where pandas imports).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from enum import Enum
from typing import Dict, Iterator, Optional

import torch


class LogKey(str, Enum):
    """Metric channels of a trainer's log."""

    E = "E"
    E_LOC = "E_LOC"
    E_LOC_VAR = "E_LOC_VAR"
    N_UNIQUE_SAMP = "N_UNIQUE_SAMP"
    TIME = "TIME"


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Profile the block with torch.profiler (the host and, where there is
    one, the card) and write it to <log_dir>/trace.json, a Chrome trace
    (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed(label: str, sink: Optional[dict] = None) -> Iterator[None]:
    """Wall time of the block: appended to sink[label], or printed."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.setdefault(label, []).append(dt)
    else:
        print(f"[timed] {label}: {dt*1000:.2f} ms", flush=True)


def device_memory_stats() -> Dict[str, dict]:
    """Per-card memory statistics: bytes in use, the peak, and the card's
    total memory as the limit."""
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


def save_log(log: dict, fname: str) -> str:
    """Persist a metrics log as JSONL (one channel entry per line) and, when
    pandas imports, as a DataFrame pickle (one column a channel, indexed by
    step). Returns the JSONL path."""
    base, _ = os.path.splitext(fname)
    jsonl = base + ".jsonl"
    with open(jsonl, "w") as f:
        for key, series in log.items():
            for step, value in series:
                f.write(json.dumps({"key": str(key), "step": step, "value": value}) + "\n")
    try:
        import pandas as pd

        frames = []
        for key, series in log.items():
            if not series:
                continue
            steps, values = zip(*series)
            frames.append(pd.DataFrame({str(key): values}, index=steps))
        if frames:
            pd.concat(frames, axis=1).to_pickle(base + ".pkl")
    except Exception:
        pass  # the pickle is optional; the JSONL is the log
    return jsonl
