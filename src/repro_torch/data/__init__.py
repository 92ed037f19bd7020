from repro_torch.data.pipeline import DataConfig, SyntheticTokens, make_batch_iterator
