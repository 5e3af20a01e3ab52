"""Metrics logging.

Counterpart of `gaussctrl_tpu/core/writer.py`: an append-only JSONL event
log (`events.jsonl`, one `{"step", "group", "t", **scalars}` record a line)
with a console echo every `echo_every` steps. The JAX package's section
timers and profiler trace context have no counterpart here.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


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
