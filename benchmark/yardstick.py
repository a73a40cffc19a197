"""The benchmark's yardstick: the H100's published peaks and the operation
and byte counts of the DGP's layers, computed from shapes alone.

Frozen copies, kept here so that a change to the program cannot move the
yardstick it is measured by:

- the peaks of ``chip_smoke.py`` (NVIDIA's H100 SXM data sheet, dense, at
  700 W; the exp rate of the CUDA C++ Programming Guide's throughput
  table for compute capability 9.0 at the 1.98 GHz boost clock);
- ``flops`` and ``flops_bwd`` of ``ops/cuda/conditional.py`` (the fused
  staged conditional) and ``bound_ms``'s byte count from ``chip_smoke.py``;
- ``flops``, ``exps`` and ``bytes_moved`` of ``ops/cuda/gram.py`` (the
  RBF gram) and ``chip_smoke.py``'s ``gram_bound_ms``.

The model counts (``train_step_flops``, ``cached_forward_flops``) count
what the model needs, once: the conditional forward and backward without a
recomputed gram, each layer's Kuu gram and Cholesky, and the KL.  Work a
route does twice, or the staging products, is not counted, so a share of
the peak read from them is a lower bound.
"""

from __future__ import annotations

FP32_PEAK = 67e12               # FLOP/s, fp32 outside the tensor cores
HBM_RATE = 3.35e12              # bytes/s
SFU_EXP_RATE = 132 * 16 * 1.98e9  # exp results/s
FLOAT_BYTES = 4                 # the cells compute in float32


def conditional_flops(B, M, Dx, Do):
    """Operations of one fused conditional forward over B rows (an FMA
    counts as two): the gram, G = K LiT, the mean and, per output, the
    variance's G W_d and its row sum."""
    return B * (2 * M * Dx + 2 * M * M + 2 * M * Do
                + Do * (2 * M * M + 2 * M))


def conditional_flops_bwd(B, M, Dx, Do, saved=True):
    """Operations of one backward of the conditional: per row the gram
    (not when it was saved), G, dK and dLiT, dX and dZ, the mean term and
    dalpha, and per output G W_d, dW_d and dG's row term."""
    gram = 0 if saved else 2 * M * Dx
    return B * (gram + 4 * M * Dx + 6 * M * M + 4 * M * Do
                + Do * (4 * M * M + 2 * M))


def conditional_floats(B, M, Dx, Do, backward=False):
    """Floats one call must move: each input read once, each output
    written once.  The forward reads X, Z, LiT, alpha, W and the two
    scalars and writes mean and var; the backward reads the forward's
    inputs and the two cotangents and writes a gradient of each tensor
    input."""
    params = M * Dx + M * M + M * Do + Do * M * M
    if backward:
        return B * Dx + params + 2 + 2 * B * Do + B * Dx + params
    return B * Dx + params + 2 + 2 * B * Do


def conditional_least_s(B, M, Dx, Do, backward=False):
    """The least seconds of one call on the H100: the larger of its bytes
    over the HBM rate and its operations over the fp32 peak.  The
    backward's operations are counted with the gram saved, whatever the
    route, so a route that recomputes the gram reads no better."""
    ops = (conditional_flops_bwd(B, M, Dx, Do, saved=True) if backward
           else conditional_flops(B, M, Dx, Do))
    return max(ops / FP32_PEAK,
               FLOAT_BYTES * conditional_floats(B, M, Dx, Do, backward)
               / HBM_RATE)


def gram_flops(N, M, D):
    """Operations of an (N, M) RBF gram over D dims besides the exps."""
    return N * M * (3 * D + 2)


def gram_exps(N, M):
    return N * M


def gram_bytes(N, M, D, itemsize=FLOAT_BYTES):
    """X, Z, the lengthscales and the variance read once, K written once."""
    return itemsize * ((N + M + 1) * D + 1 + N * M)


def gram_least_s(N, M, D):
    """The least seconds of one float32 gram call: bytes over the HBM
    rate, or operations: the flops over the fp32 peak and the exps over
    the exp rate."""
    return max(gram_bytes(N, M, D) / HBM_RATE,
               gram_flops(N, M, D) / FP32_PEAK,
               gram_exps(N, M) / SFU_EXP_RATE)


def cholesky_flops(M):
    return M ** 3 / 3


def kl_flops(M, Do):
    """The KL of one layer: the triangular solves of the Do factors of
    q_sqrt (M^3 each), the Mahalanobis solve and the log-determinants."""
    return Do * M ** 3 + 2 * M * M * Do + 2 * M


def layer_widths(config):
    """[(Dx, Do)] of each layer of a configuration file."""
    dims = [config["input_dim"]] + list(config["hidden_dims"])
    outs = list(config["hidden_dims"]) + [config["num_outputs"]]
    return list(zip(dims, outs))


def train_step_flops(config, batch):
    """Model operations of one training step at ``batch`` rows (times the
    configuration's num_samples): each layer's conditional forward and
    backward, its Kuu gram forward and backward (three grams' worth), its
    Cholesky forward and backward (three factorizations' worth) and its
    KL forward and backward (three times the forward)."""
    M = config["num_inducing"]
    B = batch * config["num_samples"]
    total = 0.0
    for Dx, Do in layer_widths(config):
        total += conditional_flops(B, M, Dx, Do)
        total += conditional_flops_bwd(B, M, Dx, Do, saved=True)
        total += 3 * gram_flops(M, M, Dx)
        total += 3 * cholesky_flops(M)
        total += 3 * kl_flops(M, Do)
    return total


def cached_forward_flops(config, rows, samples):
    """Model operations of one served request of ``rows`` rows at
    ``samples`` samples through the posterior cache, B = rows x samples
    a layer: the gram K(Z, X), G = Li K, the mean G^T alpha, the
    residual's column sums of G * G, the variance's H = C^T G and the
    column sums of H * H, and an inner layer's linear mean function X W
    (where it changes the width; the last layer's mean is zero)."""
    M = config["num_inducing"]
    B = rows * samples
    widths = layer_widths(config)
    total = 0.0
    for l, (Dx, Do) in enumerate(widths):
        total += gram_flops(B, M, Dx)
        total += 2 * M * M * B + 2 * B * M * Do + 2 * B * M
        total += 2 * Do * M * M * B + 2 * Do * M * B
        if Dx != Do and l < len(widths) - 1:
            total += 2 * B * Dx * Do
    return total
