"""Training: the Adam optimizer, the SGD step, the reject-nonfinite guard,
fit and evaluation."""
