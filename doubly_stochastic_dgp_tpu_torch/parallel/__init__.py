"""Parallelism over ``torch.distributed``: the mesh and its collectives
(``mesh.py``), the data- and sample-parallel ELBO, steps, predictions and
evaluation (``dp.py``), the collapsed DGPs' bounds and steps
(``collapsed.py``), pipeline parallelism over the layer stack
(``pp.py``); ``training.loop.fit_dp`` drives the data-parallel steps.
Output-dimension sharding (``outdim.py``) is imported by its path,
``doubly_stochastic_dgp_tpu_torch.parallel.outdim``, as in the JAX
package."""

from . import collapsed, dp, mesh, pp
from .collapsed import (collapsed_shard, damianou_shard, dp_collapsed_elbo,
                        dp_damianou_elbo, make_dp_collapsed_train_step,
                        make_dp_damianou_train_step)
from .dp import (dp_elbo, dp_predict_y, make_dp_sp_scan_train_step,
                 make_dp_train_step, sp_elbo)
from .mesh import make_mesh, pad_to_multiple, replicate, shard_along
from .pp import make_pp_train_step, pp_elbo, pp_shard, pp_stack

__all__ = ["collapsed", "dp", "mesh", "pp", "collapsed_shard",
           "damianou_shard", "dp_collapsed_elbo", "dp_damianou_elbo",
           "make_dp_collapsed_train_step", "make_dp_damianou_train_step",
           "dp_elbo", "dp_predict_y", "make_dp_sp_scan_train_step",
           "make_dp_train_step", "sp_elbo", "make_mesh", "pad_to_multiple",
           "replicate", "shard_along", "make_pp_train_step", "pp_elbo",
           "pp_shard", "pp_stack"]
