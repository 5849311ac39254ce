"""Training metrics logging: the port's counterpart of the JAX package's
`raft_stereo_tpu/utils/metrics.py` `MetricsLogger` (the reference's
`Logger`): `log_every`-step running means of every metric plus
steps_per_sec, through Python logging and as JSON lines in
<log_dir>/metrics.jsonl. The port's step hands floats, so nothing here
waits on the device. TensorBoard, which the JAX logger adds when
installed, is left out: the card's machine has none.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class MetricsLogger:
    def __init__(self, log_every: int = 100, log_dir: str = "runs", jsonl_path: Optional[str] = None):
        self.log_every = log_every
        self._pending: list = []
        self.count = 0
        self._last_time = time.perf_counter()
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = jsonl_path or os.path.join(log_dir, "metrics.jsonl")

    def push(self, metrics: Dict[str, float], step: int) -> None:
        """Buffer one step's metrics; every `log_every` steps write their
        means (and steps_per_sec over the window)."""
        self._pending.append(metrics)
        self.count += 1
        if self.count >= self.log_every:
            running: Dict[str, float] = {}
            for m in self._pending:
                for k, v in m.items():
                    running[k] = running.get(k, 0.0) + float(v)
            now = time.perf_counter()
            means = {k: v / self.count for k, v in running.items()}
            means["steps_per_sec"] = self.count / (now - self._last_time)
            self.write(means, step)
            fields = ", ".join(f"{k} {v:.4f}" for k, v in sorted(means.items()))
            logger.info("Training metrics (%d): %s", step, fields)
            self._pending = []
            self.count = 0
            # `now` (before the write) so the flush counts against the next
            # window: steps_per_sec stays an end-to-end wall-clock rate.
            self._last_time = now

    def write(self, values: Dict[str, float], step: int) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v in values.items()}}) + "\n")
