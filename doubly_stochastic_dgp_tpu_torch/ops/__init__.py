"""Numerical building blocks: kernels, likelihoods, linear algebra and the
CUDA kernels (``ops.cuda``)."""
