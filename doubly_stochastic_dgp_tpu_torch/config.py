"""Numerics configuration and device resolution for the PyTorch port.

Counterpart of ``doubly_stochastic_dgp_tpu/config.py``.  The JAX package
keeps one process-global ``Config`` that model constructors snapshot at
build time; here the ``Config`` is an explicit value handed to
``DGP.build`` (no global state), and each layer snapshots the same
fields.  Field names and defaults mirror the JAX ones so that a JAX
model's settings carry over unchanged.

Precision: every contraction in the port runs in full fp32 (or f64).
TF32 is never enabled and ``torch.backends.cuda.matmul.allow_tf32`` /
``torch.set_float32_matmul_precision`` are never touched.  The
``precision`` field ('default' | 'mixed' | 'highest') is kept only so a
JAX model's tier carries over; on the GPU every tier means fp32 until a
measurement says a cheaper one is safe.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Config", "resolve_device"]

_SOLVE_MODES = ("solve", "inverse")
_PSI2_IMPLS = ("auto", "pallas", "xla")
_PRECISIONS = ("default", "mixed", "mixed_g", "mixed_high", "highest")


@dataclasses.dataclass(frozen=True)
class Config:
    dtype: torch.dtype = torch.float64
    jitter: float = 1e-6
    # 'solve' (triangular solves) | 'inverse' (staged inverse,
    # sum-of-squares variance; diagonal only, full covariances take the
    # solves)
    solve_mode: str = "solve"
    # False | True | 'saved': route every RBF(+White) SVGP conditional
    # through the fused conditional kernels ('saved': the save-gram pair,
    # whose backward reads the forward's gram instead of recomputing it)
    use_pallas: bool | str = False
    precision: str = "mixed"
    # 'auto' | 'pallas' | 'xla': the route of the RBF psi2 data sum, with
    # the JAX field's names (ops/psi_stats.py::psi2_route).  'auto': on a
    # CUDA tensor the kernel (ops/cuda/psi2.py) where it takes the call
    # (float32, M <= 512, 1 <= D <= 32), else the plain blocked torch
    # path; on a CPU tensor the kernel's plain version.  'pallas': the
    # kernel route always, which on a CUDA tensor raises where the kernel
    # cannot take the call (the JAX 'pallas' falls back to XLA there).
    # 'xla': the plain path on any device.  The JAX 'auto' gates
    # (PSI2_KERNEL_MIN_M/MAX_D) are TPU profitability measurements and do
    # not carry over.
    psi2_impl: str = "auto"
    # recompute each layer's conditional in the backward pass
    # (torch.utils.checkpoint in DGPBase.propagate) instead of keeping its
    # (S*B, M)-class intermediates: about one more forward of work for
    # less memory; the same values and gradients
    remat: bool = False

    def __post_init__(self):
        if self.solve_mode not in _SOLVE_MODES:
            raise ValueError(f"solve_mode must be one of {_SOLVE_MODES}; "
                             f"got {self.solve_mode!r}")
        if self.precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {_PRECISIONS}; "
                             f"got {self.precision!r}")
        if self.use_pallas not in (False, True, "saved"):
            raise ValueError(
                f"use_pallas={self.use_pallas!r}: only False, True and "
                f"'saved' are ported")
        if self.psi2_impl not in _PSI2_IMPLS:
            raise ValueError(f"psi2_impl must be one of {_PSI2_IMPLS}; "
                             f"got {self.psi2_impl!r}")
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64; got "
                             f"{self.dtype}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  There is no silent CPU fallback: ``device=None`` without a
    card raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port's entry points run on the "
                "GPU by default; pass device='cpu' explicitly to run on "
                "the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device
