"""Baselines the evaluation compares Auncel with."""

from auncel_tpu_torch.baselines.laet import LearnedTermination

__all__ = ["LearnedTermination"]
