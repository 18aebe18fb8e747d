"""Structured metrics logging (port of ``tpucap.utils.logging``): one JSON
object a record, appended, each with the seconds since the logger was made
as ``wall_time`` unless the record has one; with ``tensorboard_dir``, every
int, float or bool field also as a TensorBoard scalar.

The event files are the port's own (``utils/events.py``: TFRecord framing,
CRC-32C, TF2's scalar form, written with the standard library), where
tpucap writes them through TensorFlow's ``tf.summary``: TensorBoard reads
either. ``read_scalars`` reads them back.
"""

from __future__ import annotations

import json
import sys
import time

from tpucap_torch.utils.events import EventFileWriter


class MetricsLogger:
    def __init__(self, path=None, *, echo: bool = False, tensorboard_dir=None):
        """path: JSONL file (append). tensorboard_dir: also mirror numeric
        fields as TensorBoard scalars in a new event file there. The step
        comes from a 'step' or 'epoch' field when present, else a running
        counter of ``log`` calls."""
        self._file = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.time()
        self._tb = EventFileWriter(tensorboard_dir) if tensorboard_dir else None
        self._tb_step = 0

    def log(self, record: dict) -> None:
        record = dict(record)
        record.setdefault("wall_time", round(time.time() - self._t0, 3))
        line = json.dumps(record)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._tb is not None:
            step = record.get("step", record.get("epoch", self._tb_step))
            self._tb_step += 1
            for k, v in record.items():
                if k in ("step", "epoch", "wall_time"):
                    continue
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, int(step))
        if self._echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
