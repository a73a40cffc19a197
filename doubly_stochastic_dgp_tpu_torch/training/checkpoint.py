"""Checkpoint / resume: save and restore the training state.

Counterpart of ``doubly_stochastic_dgp_tpu/training/checkpoint.py`` with
its npz backend and its ``ckpt_<step>.npz`` naming.  The JAX package's
other backend, Orbax, has no PyTorch counterpart, so there is no
``backend`` argument.

A state is a tuple whose items are an ``nn.Module`` (its named
parameters), an :class:`~.optim.AdamState` (count, mu, nu), a
``torch.Generator`` (its ``get_state()``) or a tensor.  Saving reads them
on the host (one sync per checkpoint).  Restoring copies each saved array
into the existing tensor (``copy_``), so the tensors a captured CUDA
graph holds keep their addresses, and sets each generator's state.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from .optim import AdamState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _entries(state):
    """(name, tensor or generator) of every array in ``state``."""
    for i, item in enumerate(state):
        if isinstance(item, nn.Module):
            for name, p in item.named_parameters():
                yield f"{i}:param:{name}", p
        elif isinstance(item, AdamState):
            yield f"{i}:count", item.count
            for j, (m, v) in enumerate(zip(item.mu, item.nu)):
                yield f"{i}:mu:{j}", m
                yield f"{i}:nu:{j}", v
        elif isinstance(item, (torch.Generator, torch.Tensor)):
            yield f"{i}", item
        else:
            raise TypeError(f"checkpoint: cannot save a "
                            f"{type(item).__name__}")


def save_checkpoint(ckpt_dir: str, state, step: int):
    """Write ``state`` at ``step`` to ``<ckpt_dir>/ckpt_<step>.npz`` (by a
    rename, so a reader never sees half a file); returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {}
    for name, t in _entries(state):
        t = t.get_state() if isinstance(t, torch.Generator) else t.detach()
        arrays[name] = t.cpu().numpy()
    arrays["__step__"] = np.asarray(step)
    path = os.path.join(ckpt_dir, f"ckpt_{step}.npz")
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **arrays)
    os.replace(path + ".tmp", path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step with a ``ckpt_<step>.npz`` in ``ckpt_dir``, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for f in os.listdir(ckpt_dir):
        if f.startswith("ckpt_") and f.endswith(".npz"):
            try:
                steps.append(int(f[5:-4]))
            except ValueError:
                pass
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, template, step: Optional[int] = None):
    """Restore ``step`` (default: the latest) into ``template``, a state
    of the saved structure, in place; returns (template, step), or
    (template, None) when there is nothing to restore."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return template, None
    with np.load(os.path.join(ckpt_dir, f"ckpt_{step}.npz")) as data:
        for name, t in _entries(template):
            if name not in data:
                raise ValueError(f"checkpoint step {step}: no {name!r}")
            arr = torch.from_numpy(data[name])
            if isinstance(t, torch.Generator):
                t.set_state(arr)
                continue
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint step {step}: {name!r} has "
                                 f"shape {tuple(arr.shape)}, the template "
                                 f"{tuple(t.shape)}")
            t.copy_(arr)
        return template, int(data["__step__"])
