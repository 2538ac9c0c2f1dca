"""Serving: the batched generation engine and its HTTP endpoint."""
