"""Runnable examples, the counterparts of the repo's ``examples/``:
``python -m repro_torch.examples.<name> [--device cpu]`` for ``quickstart``,
``multi_tenant``, ``reconfig_demo``, ``serve_lm`` and ``train_lm``."""
