"""Experiment metrics logging.

Port of `mmpl_tpu/utils/metrics.py:MetricsLogger` without the wandb
mirror: one JSON object per step appended to `<dir>/<run>/metrics.jsonl`
(host side only, no device sync beyond the scalars the caller pulled) and
the run config written once to `config.json`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str = "runs", run_name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None):
        run_name = run_name or time.strftime("run-%Y%m%d-%H%M%S")
        self.dir = os.path.join(log_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.jsonl")
        self._t0 = time.time()
        if config is not None:
            with open(os.path.join(self.dir, "config.json"), "w",
                      encoding="utf-8") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, step: int, **scalars: float) -> None:
        rec = {"step": int(step),
               "time": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
