"""Scripts that measure or check the port end to end: the paper's tables
(one module a JAX ``benchmarks/`` script, ``table1_utilization`` ...
``table13_prefix``), their harness (``run``, ``trajectory``) and what they
share (``common``), the chunking localiser and the prefill timer."""
