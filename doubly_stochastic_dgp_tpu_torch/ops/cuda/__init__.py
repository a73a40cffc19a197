"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Building happens at first use (``build.py``), never at import.
Importing this package registers the forward launches as the ops
``torch.ops.dsdgp.*``, which is all a loaded exported program needs."""

from . import conditional, gram, psi2  # noqa: F401  (register the ops)
