"""Utilities: stage tracing (``utils.tracing``)."""
