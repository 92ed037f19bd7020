"""The roofline on the card: a step's FLOPs, bytes and collective traffic
a rank, counted on meta tensors (:mod:`.analysis`), their affine fit over
depth (:mod:`.extrapolate`) and the dry run's tables (:mod:`.report`).

``repro/roofline/unrolling.py`` has no counterpart: it exists because
XLA's ``cost_analysis`` counts a ``lax.scan`` body once, so the JAX
package unrolls its loops to count them; the port has no scan, every layer
and every chunk runs eagerly and is counted where it runs.  Neither has
``repro/_compat.py``, a shim for old ``jax`` versions, which the port (it
imports no ``jax``) does not need.
"""
