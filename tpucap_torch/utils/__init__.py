"""Utilities of the port: the JSONL metrics logger."""

from tpucap_torch.utils.logging import MetricsLogger

__all__ = ["MetricsLogger"]
