"""Runnable examples: ``python -m repro_torch.examples.train_lm``."""
