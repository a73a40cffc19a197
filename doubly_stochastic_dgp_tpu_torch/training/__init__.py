"""Training: the Adam optimizer, natural gradients, L-BFGS, the SGD and
alternating steps, the reject-nonfinite guard, fit and evaluation, and
the MCMC samplers (HMC, NUTS)."""

from .loop import (evaluate_classification, evaluate_regression, fit,
                   fit_dp, make_natgrad_adam_step, make_scan_train_step,
                   make_sgd_train_step)
from .natgrad import NaturalGradient, natgrad_update
from .optim import lbfgs_minimize, make_train_step, masked_optimizer
from .hmc import (effective_sample_size, hmc_sample, hmc_sample_chains,
                  potential_scale_reduction)
from .nuts import nuts_sample, nuts_sample_chains
