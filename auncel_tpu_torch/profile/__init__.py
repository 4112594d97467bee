"""Offline error profile and bounded search."""
