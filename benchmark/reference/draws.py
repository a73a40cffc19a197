"""The random numbers the program draws, drawn again for the reference.

The program draws with ``torch.Generator`` streams on its device (PyTorch's
own generators, not the program's code): a training step draws its
minibatch's row indices uniformly with replacement (when the batch is
smaller than the training set), then each layer's unit normals (S, B,
Do_l) in layer order; a served request draws each layer's normals (S,
rows, Do_l) from a generator seeded with ``derive_seed(base, i)`` for the
server's i-th request.  Drawing the same shapes in the same order from a
generator of the same device and seed gives the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch


def derive_seed(base: int, index: int) -> int:
    """The 63-bit seed of request ``index`` of a server seeded with
    ``base``: numpy's SeedSequence of the pair, as the server documents."""
    state = np.random.SeedSequence([int(base), int(index)]).generate_state(
        1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def train_draws(seed, steps, num_rows, batch, samples, widths, device,
                dtype=torch.float32):
    """[(row indices or None, [normals of each layer])] of ``steps``
    training steps from a generator seeded with ``seed``, the normals in
    the ``dtype`` the program computes in."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    out = []
    for _ in range(steps):
        idx = None
        if batch < num_rows:
            idx = torch.randint(0, num_rows, (batch,), generator=g,
                                device=device)
        rows = batch if idx is not None else num_rows
        zs = [torch.randn((samples, rows, Do), generator=g, dtype=dtype,
                          device=device)
              for _, Do in widths]
        out.append((idx, zs))
    return out


def request_draws(seed, samples, rows, widths, device,
                  dtype=torch.float32):
    """The normals of one request of ``rows`` rows at ``samples`` samples,
    from a generator seeded with ``seed``, in the program's ``dtype``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return [torch.randn((samples, rows, Do), generator=g, dtype=dtype,
                        device=device)
            for _, Do in widths]
