"""Data and sample parallelism over ``torch.distributed``: the mesh and
its collectives (``mesh.py``), the data- and sample-parallel ELBO, steps,
predictions and evaluation (``dp.py``) and the collapsed DGPs' bounds and
steps (``collapsed.py``).  ``training.loop.fit_dp`` drives them."""

from . import collapsed, dp, mesh
from .collapsed import (collapsed_shard, damianou_shard, dp_collapsed_elbo,
                        dp_damianou_elbo, make_dp_collapsed_train_step,
                        make_dp_damianou_train_step)
from .dp import (dp_elbo, dp_predict_y, make_dp_sp_scan_train_step,
                 make_dp_train_step, sp_elbo)
from .mesh import make_mesh, pad_to_multiple, replicate, shard_along

__all__ = ["collapsed", "dp", "mesh", "collapsed_shard", "damianou_shard",
           "dp_collapsed_elbo", "dp_damianou_elbo",
           "make_dp_collapsed_train_step", "make_dp_damianou_train_step",
           "dp_elbo", "dp_predict_y", "make_dp_sp_scan_train_step",
           "make_dp_train_step", "sp_elbo", "make_mesh", "pad_to_multiple",
           "replicate", "shard_along"]
