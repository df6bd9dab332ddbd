"""Configs copied from ``repro.configs`` (imports rewritten)."""
