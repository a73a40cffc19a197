"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Building happens at first use (``build.py``), never at import."""
