"""Training: the masked Adam optimizer, the SGD step, fit and evaluation."""
