"""doubly_stochastic_dgp_tpu_torch: the PyTorch/CUDA port of the
doubly-stochastic deep GP package ``doubly_stochastic_dgp_tpu``.

This package covers the training and serving paths of the Monte-Carlo
DGP: SVGP layers with identity/PCA skip connections or input propagation
under every ``Config`` numerics mode, on every kernel of the JAX package
(RBF, Matern 1/2, 3/2, 5/2, rational quadratic, cosine, periodic,
arc-cosine, White, Constant, Linear, their Sums and Products), the
quadrature DGP (``DGPQuad``) and the heteroscedastic-noise DGP
(``DGPHeteroscedastic``), the nine likelihoods (Gaussian, and by
Gauss-Hermite quadrature Bernoulli, the robust-max MultiClass, Poisson,
Exponential, StudentT, Gamma, Beta, Ordinal), the doubly-stochastic ELBO
with the layers' KL terms, Adam training on on-device minibatches
(``fit``, with the monitors of ``training/monitor.py``), diagonal and
full-covariance predictions, the regression and classification metrics
(``evaluate_regression``, ``evaluate_classification``), the cached
posterior and ``make_server``; the data loaders (``data/datasets.py``,
``data/native.py``); and the collapsed DGPs (``DGPCollapsed``,
``DGPDamianou``: collapsed ``SGPRLayer``s and the psi statistics of RBF,
Linear and their Sums with White): their
bound, their predictions, and their training by ``fit`` on the whole
training set under the reject-nonfinite guard; natural-gradient steps
(``NaturalGradient``, ``fit(natgrad_gamma=, ng_layers=)``: NatGrad and Adam
in turns), L-BFGS (``lbfgs_minimize``), the single-layer baselines
(``SVGP``, ``GPR``, ``SGPR``, ``GPRFITC``, on ``GPRLayer`` and
``SGPRLayer``) and the serving cache of every family; MCMC over the
inducing values of ``SGPMCLayer`` stacks and over the ``GPMCLayer`` of
``DGPHeinonen`` (``hmc_sample``, ``nuts_sample`` and their multi-chain
forms, as captured graphs on the card, with ``potential_scale_reduction``
and ``effective_sample_size``); call-time sample counts
(``DynamicPredictor``) and exported prediction programs
(``export_predict_y``, ``load_exported``, through ``torch.export``);
and data and sample parallelism over ``torch.distributed`` (``parallel``:
meshes of ranks with the port's collectives, the data- and
sample-parallel ELBO, its scanned steps and ``fit_dp``, predictions and
evaluation over the ranks, the collapsed DGPs' bounds and steps with the
rows split, and the MCMC chains split over ranks by ``mesh=``), and
output-dimension and pipeline parallelism (``parallel.outdim``: every
layer's latent dims split over a mesh axis, also composed with the data
and sample axes; ``parallel.pp``: a homogeneous layer stack split over
stages on a GPipe schedule); the parameter table (``summary``) and
numerics rewrites of a built model (``with_config``).
The fused staged
conditional and the psi2 data sum run as hand-written CUDA kernels,
forward and backward, the conditional also with a save-gram variant, and
every RBF gram on the card runs in the ``rbf_gram`` kernel
(``ops/cuda``).
It imports torch, numpy and scipy only — never jax or the JAX package.
Entry points run on the GPU unless the caller passes ``device='cpu'``.
"""

from .config import Config, resolve_device
from .convert import load_reference_state
from .data.datasets import (Datasets, SyntheticRegression, load_mnist_npz,
                            make_synthetic_regression)
from .models.damianou import DGPDamianou
from .models.dgp import DGP, DGPBase, DGPQuad
from .models.initializations import init_layers_input_prop, init_layers_linear
from .models.dynamic import DynamicPredictor
from .models.layers import (GPMCLayer, GPRLayer, SGPMCLayer, SGPRLayer,
                            SVGPLayer)
from .models.zoo import DGPCollapsed, DGPHeinonen, DGPHeteroscedastic
from .models.mean_functions import Constant as ConstantMean
from .models.mean_functions import Identity, Linear, Zero
from .models.posterior import (CachedSingleLayerGP, CachedSVGPLayer,
                               precompute)
from .models.single_layer import GPR, GPRFITC, SGPR, SVGP
from .ops.cuda.conditional import fused_conditional, fused_conditional_saved
from .ops.cuda.psi2 import psi2_core
from .ops.kernels import (RBF, ArcCosine, Constant, Cosine, Kernel,
                          Linear as LinearKernel, Matern12, Matern32,
                          Matern52, Periodic, Product, RationalQuadratic,
                          Sum, White)
from .ops.likelihoods import (Bernoulli, Beta, Exponential, Gamma, Gaussian,
                              Likelihood, MultiClass, Ordinal, Poisson,
                              StudentT)
from .serving import export_fn, export_predict_y, load_exported, make_server
from .training.hmc import (effective_sample_size, hmc_sample,
                           hmc_sample_chains, potential_scale_reduction)
from .training.nuts import nuts_sample, nuts_sample_chains
from .training.loop import (evaluate_classification, evaluate_regression,
                            fit, fit_dp, make_natgrad_adam_step)
from . import parallel
from .parallel import (collapsed_shard, damianou_shard, dp_collapsed_elbo,
                       dp_damianou_elbo, dp_elbo, dp_predict_y,
                       make_dp_collapsed_train_step,
                       make_dp_damianou_train_step,
                       make_dp_sp_scan_train_step, make_dp_train_step,
                       make_mesh, pad_to_multiple, replicate, shard_along,
                       sp_elbo)
from .training.natgrad import NaturalGradient, natgrad_update
from .training.optim import lbfgs_minimize, make_train_step
from .utils.modules import summary, with_config
from .utils.params import log_prior

__all__ = [
    "Config", "resolve_device", "load_reference_state",
    "SyntheticRegression", "Datasets", "load_mnist_npz",
    "make_synthetic_regression", "DGP", "DGPBase", "DGPQuad",
    "DGPCollapsed", "DGPHeteroscedastic", "DGPDamianou", "DGPHeinonen",
    "init_layers_linear", "init_layers_input_prop", "SVGPLayer",
    "SGPMCLayer", "GPMCLayer", "SGPRLayer", "GPRLayer", "SVGP", "GPR", "SGPR", "GPRFITC", "Identity",
    "Linear", "Zero", "ConstantMean", "CachedSVGPLayer",
    "CachedSingleLayerGP", "precompute", "fused_conditional",
    "fused_conditional_saved", "psi2_core", "Kernel", "RBF", "Matern12",
    "Matern32", "Matern52", "RationalQuadratic", "Cosine", "Periodic",
    "ArcCosine", "White", "Constant", "LinearKernel", "Sum", "Product",
    "Likelihood", "Gaussian", "Bernoulli", "MultiClass", "Poisson",
    "Exponential", "StudentT", "Gamma", "Beta", "Ordinal", "make_server",
    "evaluate_regression", "evaluate_classification", "fit", "log_prior",
    "NaturalGradient", "natgrad_update", "make_natgrad_adam_step",
    "lbfgs_minimize", "make_train_step", "DynamicPredictor", "export_fn",
    "export_predict_y", "load_exported", "hmc_sample", "hmc_sample_chains",
    "nuts_sample", "nuts_sample_chains", "potential_scale_reduction",
    "effective_sample_size", "fit_dp", "parallel", "collapsed_shard",
    "damianou_shard", "dp_collapsed_elbo", "dp_damianou_elbo", "dp_elbo",
    "dp_predict_y", "make_dp_collapsed_train_step",
    "make_dp_damianou_train_step", "make_dp_sp_scan_train_step",
    "make_dp_train_step", "make_mesh", "pad_to_multiple", "replicate",
    "shard_along", "sp_elbo", "summary", "with_config",
]
