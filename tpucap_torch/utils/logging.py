"""JSONL metrics logging (the JSONL half of ``tpucap.utils.logging``): one
JSON object a record, appended, each with the seconds since the logger
was made as ``wall_time`` unless the record has one."""

from __future__ import annotations

import json
import sys
import time


class MetricsLogger:
    def __init__(self, path=None, *, echo: bool = False, tensorboard_dir=None):
        """path: JSONL file (append). ``tensorboard_dir`` needs TensorFlow's
        summary writer in tpucap and is not ported."""
        if tensorboard_dir:
            raise NotImplementedError("tensorboard_dir is not ported (it needs TensorFlow)")
        self._file = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.time()

    def log(self, record: dict) -> None:
        record = dict(record)
        record.setdefault("wall_time", round(time.time() - self._t0, 3))
        line = json.dumps(record)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
