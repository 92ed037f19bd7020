"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Same layout as the JAX package (``configs``, ``core``, ``kernels``,
``models``, ``serve``); model code calls ``dispatch.op(name, ...)`` and the
registry resolves each op to a hand-written Hopper kernel (source ``cuda``),
a torch eager formulation (``torch``) or the torch oracle (``reference``).
Nothing here imports JAX or the ``repro`` package.
"""
