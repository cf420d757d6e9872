"""Structured logging.

The reference's observability is std::cout/print scattered through the
engine and driver plus the ``test_out`` debug channel (SURVEY.md section 5).
Here: a standard logging.Logger for the human stream and a JSONL metrics
logger for machine-readable training curves (loss, lr, epoch time, eval
metrics) — the artifact the reference's README "expected output" losses
would be scraped from.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Optional

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "heat_cf") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


class MetricsLogger:
    """Append-only JSONL metrics stream (one record per event)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None

    def log(self, event: str, **fields: Any) -> None:
        record = {"event": event, "ts": time.time(), **fields}
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
