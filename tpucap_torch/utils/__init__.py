"""Utilities of the port: structured metrics logging (JSONL and TensorBoard
event files), profiling hooks and debug guards, under tpucap's names."""

from tpucap_torch.utils.debug import checked, debug_mode
from tpucap_torch.utils.events import read_scalars
from tpucap_torch.utils.logging import MetricsLogger
from tpucap_torch.utils.profiling import StepTimer, profile_trace

__all__ = ["MetricsLogger", "StepTimer", "checked", "debug_mode", "profile_trace", "read_scalars"]
