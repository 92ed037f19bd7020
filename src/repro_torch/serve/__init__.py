"""Serving: the batched dense engine."""
