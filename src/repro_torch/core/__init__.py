"""Transparent dispatch: the kernel registry and the scoped dispatch policy."""
