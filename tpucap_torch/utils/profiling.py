"""Profiling hooks (port of ``tpucap.utils.profiling``).

- ``profile_trace(log_dir)``: a context manager around
  ``torch.profiler.profile`` (CPU, and CUDA on the card) that writes a
  Chrome trace JSON into ``log_dir`` on exit: open it in Perfetto
  (ui.perfetto.dev) or ``chrome://tracing``. tpucap's trace is a
  TensorBoard profile; this is the port's form of it. On the card a trace
  without a CUDA kernel event raises (CUPTI gave nothing) and leaves no
  file behind.
- ``StepTimer``: wall-clock step timing that synchronizes by copying a
  (small) result to the host, as tpucap's ``device_get`` does.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time

import numpy as np
import torch

from tpucap_torch.core import tree_leaves


class Trace:
    """What ``profile_trace`` yields: ``path`` is the trace file once the
    block has ended."""

    path: str | None = None


def _kernel_events(path: str) -> int:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") == "kernel")


@contextlib.contextmanager
def profile_trace(log_dir: str, *, cuda: bool | None = None):
    """Trace the block into ``log_dir/<host>.<pid>.<ns>.pt.trace.json``.
    cuda: trace the card's activity too (default: whether torch sees a
    card); then the trace must hold a CUDA kernel event."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    trace = Trace()
    with torch.profiler.profile(activities=activities) as prof:
        yield trace
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(
        str(log_dir), f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
    )
    try:
        prof.export_chrome_trace(path)
        if cuda and not _kernel_events(path):
            raise RuntimeError(
                "profile_trace: the trace holds no CUDA kernel event (CUPTI "
                "traced nothing on the card)"
            )
    except BaseException:
        if os.path.exists(path):
            os.remove(path)
        raise
    trace.path = path


class StepTimer:
    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        """Pass a small device tensor (e.g. the loss), or a tree of them, to
        synchronize on."""
        if sync_value is not None:
            for leaf in tree_leaves(sync_value):
                np.asarray(leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0

    def rate(self, items_per_step: int) -> float:
        return items_per_step / self.median if self.median else 0.0
