"""Offline error profile and bounded search."""

from auncel_tpu_torch.profile.error_sys import ErrorSys
from auncel_tpu_torch.profile.trace import (
    TraceSet, save_trace_set, load_trace_set)
from auncel_tpu_torch.profile.trainer import train_profile
from auncel_tpu_torch.profile.bounded import bounded_search, budgeted_search

__all__ = [
    "ErrorSys", "TraceSet", "save_trace_set", "load_trace_set",
    "train_profile", "bounded_search", "budgeted_search",
]
