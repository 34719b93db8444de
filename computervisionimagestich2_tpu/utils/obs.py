"""Observability: structured logging, stage timing, profiler hooks.

The reference's observability is cout index prints and interactive
display() calls (ImageProcess.cpp:183,233,391) plus one clock() print
(src/ex6/ImageProcess.cpp:6-13) — SURVEY.md §5. Here:

- ``log``      — structured key=value stage logging (enabled via
  PANORAMA_TPU_LOG=1 or set_verbose(True));
- ``StageTimer`` — wall-clock per stage, exposed on Stitcher.stage_times
  (reproduces the end-to-end seconds print via the CLI --timing flag);
- ``trace``    — context manager around jax.profiler for device traces
  (PANORAMA_TPU_TRACE=/path enables).
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

_VERBOSE = os.environ.get("PANORAMA_TPU_LOG", "") not in ("", "0")


def set_verbose(v: bool) -> None:
    global _VERBOSE
    _VERBOSE = v


def log(stage: str, **kv) -> None:
    if _VERBOSE:
        items = " ".join(f"{k}={v}" for k, v in kv.items())
        print(f"[panorama-tpu] {stage} {items}", file=sys.stderr, flush=True)


def warn(stage: str, **kv) -> None:
    """Always-on warning for conditions that must never pass silently
    (e.g. static-capacity truncation — VERDICT r1 #8)."""
    items = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[panorama-tpu] WARNING {stage} {items}", file=sys.stderr,
          flush=True)


def log_sift_overflow(stats) -> None:
    """Report static-capacity truncation (never silent — VERDICT r1 #8).

    stats: [N, 4] array or list of [4] int32 rows: dropped [candidates,
    refined keypoints, descriptors, final-capacity keypoints] per image."""
    import numpy as np

    arr = np.asarray(stats)
    if arr.ndim == 1:
        arr = arr[None]
    for i, row in enumerate(arr):
        if row.sum() > 0:
            warn("sift_overflow", image=i,
                 dropped_candidates=int(row[0]),
                 dropped_keypoints=int(row[1]),
                 dropped_descriptors=int(row[2]),
                 dropped_final=int(row[3]))


def log_sift_overflow_async(stats):
    """log_sift_overflow without blocking the caller: np.asarray(stats)
    waits for every dispatched program feeding the stats, which would
    serialize pipelined batch APIs. Best-effort (a daemon thread may not
    flush if the process exits immediately). Returns the thread so tests
    can join it."""
    import threading

    t = threading.Thread(target=lambda: log_sift_overflow(stats),
                         daemon=True)
    t.start()
    return t


class StageTimer:
    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = time.perf_counter() - t0
            log(name, seconds=round(self.times[name], 3))


@contextlib.contextmanager
def trace(label: str = "panorama"):
    """jax.profiler trace if PANORAMA_TPU_TRACE points at a directory."""
    trace_dir = os.environ.get("PANORAMA_TPU_TRACE")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(os.path.join(trace_dir, label)):
        yield
