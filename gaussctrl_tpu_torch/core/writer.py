"""Metrics logging and profiler traces.

Counterpart of `gaussctrl_tpu/core/writer.py`: an append-only JSONL event
log (`events.jsonl`, one `{"step", "group", "t", **scalars}` record a line)
with a console echo every `echo_every` steps, and `cuda_trace`, the
counterpart of its `tpu_trace`: a `torch.profiler` trace written as a
Chrome trace. The JAX package's section timers have no counterpart: nothing
calls them.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Optional

import torch


class MetricsWriter:
    """Append-only JSONL scalar log (`events.jsonl`) with console echo."""

    def __init__(self, log_dir: Optional[str] = None, echo: bool = True,
                 echo_every: int = 50):
        self.path = None
        if log_dir is not None:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self.path = Path(log_dir) / "events.jsonl"
            self._fh = open(self.path, "a")
        self.echo = echo
        self.echo_every = echo_every
        self._t0 = time.time()

    def write(self, step: int, scalars: dict, group: str = "train"):
        rec = {"step": step, "group": group,
               "t": round(time.time() - self._t0, 3),
               **{k: float(v) for k, v in scalars.items()}}
        if self.path is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo and step % self.echo_every == 0:
            body = " ".join(f"{k}={v:.5g}" for k, v in scalars.items())
            print(f"[{group} {step}] {body}", flush=True)

    def close(self):
        if self.path is not None:
            self._fh.close()


@contextlib.contextmanager
def cuda_trace(log_dir: str, enabled: bool = True):
    """Trace the block with `torch.profiler` (the counterpart of the JAX
    package's `tpu_trace`): CPU activity, and the card's kernels and copies
    where torch sees a card. Yields the profiler (None when disabled); on
    exit the trace is written to `<log_dir>/trace-<time>-<pid>.json`, which
    chrome://tracing and Perfetto read. With `enabled=False` nothing is
    traced or written."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    stamp = time.strftime("%Y%m%d-%H%M%S")
    prof.export_chrome_trace(
        str(Path(log_dir) / f"trace-{stamp}-{os.getpid()}.json"))
