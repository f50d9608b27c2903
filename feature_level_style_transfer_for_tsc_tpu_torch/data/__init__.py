"""Dataset loading: the .ts parser, label-dict datasets, synthetic data (numpy only)."""
