"""Training: the synthetic data stream, the optimizers and the loop."""
