"""Execution backends: the threads backend's sequential path."""
