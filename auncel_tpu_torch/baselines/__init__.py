"""Baselines the evaluation compares Auncel with."""
