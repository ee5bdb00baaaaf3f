"""Per-stage wall-clock timing (the host half of ldso_tpu/utils/timing.py).

A stage timer registry with per-stage totals and counts, plus an optional
per-frame log file (LDSO_TPU_TIME_LOG), like the reference's
logs/time.txt (run_dso_tum_mono.cc:358-460). Device work is asynchronous,
so a stage's time is its host enqueue time unless the stage synchronises."""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict


class StageTimer:
    def __init__(self):
        self.total: Dict[str, float] = collections.defaultdict(float)
        self.count: Dict[str, int] = collections.defaultdict(int)
        self._frame_log = None
        log_path = os.environ.get("LDSO_TPU_TIME_LOG")
        if log_path:
            self._frame_log = open(log_path, "w")

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.total[name] += dt
            self.count[name] += 1

    def log_frame(self, frame_id: int, ms: float):
        """Per-frame timing line (the reference's logs/time.txt)."""
        if self._frame_log is not None:
            self._frame_log.write(f"{frame_id} {ms:.3f}\n")
            self._frame_log.flush()

    def summary(self) -> str:
        lines = []
        for k in sorted(self.total, key=lambda k: -self.total[k]):
            n = max(self.count[k], 1)
            lines.append(f"{k:32s} total {self.total[k]:8.2f}s  "
                         f"n={self.count[k]:5d}  {self.total[k]/n*1000:8.1f} ms")
        return "\n".join(lines)
