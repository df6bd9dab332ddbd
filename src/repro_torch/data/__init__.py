"""Synthetic multi-task requests copied from ``repro.data.synthetic``."""
