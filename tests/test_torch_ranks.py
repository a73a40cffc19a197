"""The rank side of the port's parallel cases (no test items here).

``doubly_stochastic_dgp_tpu_torch.parallel.mesh.run_ranks`` runs each
``*_ranks`` function below in every rank of a gloo group of spawned CPU
processes; a rank imports torch, numpy and the port only, never JAX.  The
tests ``test_torch_{conditional,modules,paths}.py`` build the models
(pickled port modules, their state carried over from the JAX package
where a case compares with it), hand them over with the data and the
draws, and hold the numpy results the ranks send back against the JAX
package's mesh functions, its single-device gradients and the port's
single-process functions.

A rank's results carry its gradients by parameter name, its parameters
after a step, and what it drew (``Recorder``), so a test can feed the
single-process step the union of the ranks' rows and the same draws."""

import pickle
import warnings

import numpy as np
import torch

import doubly_stochastic_dgp_tpu_torch as port
from doubly_stochastic_dgp_tpu_torch.graphs import randint, randn
from doubly_stochastic_dgp_tpu_torch.parallel import collapsed as pcoll
from doubly_stochastic_dgp_tpu_torch.parallel import dp as pdp
from doubly_stochastic_dgp_tpu_torch.parallel import mesh as pmesh
from doubly_stochastic_dgp_tpu_torch.parallel import outdim as pod
from doubly_stochastic_dgp_tpu_torch.parallel import pp as ppp
from doubly_stochastic_dgp_tpu_torch.training import hmc as thmc
from doubly_stochastic_dgp_tpu_torch.training import nuts as tnuts
from doubly_stochastic_dgp_tpu_torch.training.optim import (
    freeze_q_params, masked_optimizer)
from doubly_stochastic_dgp_tpu_torch.utils.params import Param

CHAIN_SEED = 7


def np_(t):
    return t.detach().double().cpu().numpy()


def named(model):
    return {n: np_(p) for n, p in model.named_parameters()}


def grads_of(model, objective, mesh, axis=None, local=(), local_axes=()):
    """(value, {name: gradient}) of a replicated objective under the
    gradient rule."""
    params = [p for p in model.parameters() if p.requires_grad]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    value, grads = pdp.dp_value_and_grads(objective, params, mesh, axis,
                                          local, local_axes)
    return float(value), {n: np_(g) for n, g in zip(names, grads)}


def error_of(fn):
    """(exception type name, message) of ``fn()``, or None."""
    try:
        fn()
    except Exception as e:                              # noqa: BLE001
        return type(e).__name__, str(e)
    return None


class Recorder:
    """A draw source that draws from a generator and keeps every draw."""

    def __init__(self, generator):
        self.generator, self.draws = generator, []

    def draw(self, kind, shape, dtype, device, high=None):
        if kind == "randint":
            out = randint(high, shape, self.generator, device)
        else:
            out = randn(shape, self.generator, dtype, device)
        self.draws.append((kind, out.numpy().copy()))
        return out


class QuadTarget(torch.nn.Module):
    """A correlated 3-D Gaussian log density over one Param (the MCMC
    chains' target)."""

    A = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, 0.3], [0.0, 0.3, 0.5]])

    def __init__(self):
        super().__init__()
        self.v = Param(np.zeros(3))


def quad_logp(m):
    v = m.v.value
    return -0.5 * v @ torch.as_tensor(QuadTarget.A) @ v


def chains(mesh, num_chains=2, **kw):
    """HMC and NUTS chains on ``QuadTarget`` from a generator seeded with
    CHAIN_SEED; with ``mesh`` split over it, else in this process."""
    out = {}
    for name, fn, extra in (("hmc", thmc.hmc_sample_chains,
                             dict(num_leapfrog=4)),
                            ("nuts", tnuts.nuts_sample_chains,
                             dict(max_depth=4))):
        g = torch.Generator().manual_seed(CHAIN_SEED)
        s, acc, _, info = fn(QuadTarget(), quad_logp, g,
                             num_chains=num_chains, num_samples=6,
                             num_burn=4, step_size=0.4, mesh=mesh, **extra,
                             **kw)
        out[name] = (np_(s), np.asarray(acc),
                     {k: np.asarray(v) for k, v in info.items()})
    return out


# ---------------------------------------------------------------------------
# test_torch_conditional: the data- and sample-parallel ELBO against JAX,
# and the chains
# ---------------------------------------------------------------------------

def conditional_ranks(rank, payload):
    """2 ranks: ``dp_elbo`` on an even and an odd batch (values and
    gradients), ``sp_elbo`` on a 'sample' mesh, the MCMC chains split
    over the ranks, and ``shard_chains``'s refusal."""
    model = pickle.loads(payload["model"])
    data = pmesh.make_mesh(num_devices=2)
    from torch.distributed.device_mesh import init_device_mesh
    sample = init_device_mesh("cpu", (2,), mesh_dim_names=("sample",))
    out = {}
    for case in ("even", "odd"):
        X, Y = payload[f"X_{case}"], payload[f"Y_{case}"]
        out[f"dp_elbo {case}"] = grads_of(
            model, lambda: port.dp_elbo(model, X, Y, None, data,
                                        zs=payload["zs_rows1"]), data)
    with torch.no_grad():
        out["dp_elbo seed"] = float(port.dp_elbo(
            model, payload["X_even"], payload["Y_even"], 3, data))
    out["sp_elbo"] = grads_of(
        model, lambda: port.sp_elbo(model, model.X_data, model.Y_data, None,
                                    sample, zs=payload["zs_full"]), sample)
    out["chains"] = chains(data)
    out["shard_chains 3"] = error_of(lambda: chains(data, num_chains=3))
    return out


def mesh2x2_ranks(rank, payload):
    """4 ranks on a (data 2 x sample 2) mesh: ``sp_elbo`` over 'sample'
    and ``dp_elbo`` over 'data', values and gradients summed over the
    whole mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    model = pickle.loads(payload["model"])
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "sample"))
    return {
        "sp_elbo": grads_of(model, lambda: port.sp_elbo(
            model, model.X_data, model.Y_data, None, mesh, axis="sample",
            zs=payload["zs_full"]), mesh),
        "dp_elbo": grads_of(model, lambda: port.dp_elbo(
            model, payload["X_odd"], payload["Y_odd"], None, mesh,
            axis="data", zs=payload["zs_rows1"]), mesh),
        "coords": (pmesh.axis_index(mesh, "data"),
                   pmesh.axis_index(mesh, "sample"))}


# ---------------------------------------------------------------------------
# test_torch_modules: the collapsed bounds and steps, and the mesh helpers
# ---------------------------------------------------------------------------

def modules_ranks(rank, payload):
    """2 ranks: ``dp_damianou_elbo`` on the whole and on the placed model
    (values, replicated gradients, each rank's q(H) rows' gradients) and
    one ``make_dp_damianou_train_step`` step; ``dp_collapsed_elbo`` with
    an SGPR and a GPR final layer (values and gradients) and one
    ``make_dp_collapsed_train_step`` step; the refusals; the mesh
    helpers; then :func:`outdim_pp_ranks`."""
    mesh = pmesh.make_mesh()
    out = {}
    dam = pickle.loads(payload["damianou"])
    out["damianou whole"] = float(pcoll.dp_damianou_elbo(dam, mesh))
    placed = pcoll.damianou_shard(dam, mesh)
    rows = pcoll._row_params(placed)
    out["damianou placed"] = grads_of(
        placed, lambda: pcoll.dp_damianou_elbo(placed, mesh), mesh,
        local=rows)
    out["damianou specs"] = pcoll.damianou_specs(dam)
    opt = masked_optimizer(placed, 0.01)
    loss = pcoll.make_dp_damianou_train_step(opt, mesh)(placed)
    out["damianou step"] = (float(loss), named(placed))
    for case in ("sgpr", "gpr"):
        m = pickle.loads(payload[case])
        out[f"collapsed {case}"] = grads_of(
            m, lambda: pcoll.dp_collapsed_elbo(m, mesh, zs=payload["zs"]),
            mesh)
        placed_c = pcoll.collapsed_shard(m, mesh)
        out[f"collapsed {case} placed"] = float(pcoll.dp_collapsed_elbo(
            placed_c, mesh, zs=payload["zs"]))
    m = pickle.loads(payload["sgpr"])
    opt = masked_optimizer(m, 0.01)
    loss = pcoll.make_dp_collapsed_train_step(opt, mesh)(m, seed=5)
    out["collapsed step"] = (float(loss), named(m))
    out["heinonen"] = error_of(lambda: pcoll.dp_collapsed_elbo(
        pickle.loads(payload["heinonen"]), mesh))
    x = torch.arange(10.0).reshape(5, 2)
    out["pad"] = np_(pmesh.pad_to_multiple(x, 4)[0])
    out["shard_along"] = np_(pmesh.shard_along(torch.arange(6.0), mesh))
    out["shard_along 5"] = error_of(
        lambda: pmesh.shard_along(torch.arange(5.0), mesh))
    rep = QuadTarget()
    with torch.no_grad():
        rep.v.unconstrained.fill_(float(rank + 1))
    pmesh.replicate(rep, mesh)
    out["replicate"] = np_(rep.v.unconstrained)
    out["gather"] = np_(pmesh.all_gather(torch.full((2, 1), float(rank)),
                                         mesh, "data"))
    out["make_mesh 3"] = error_of(lambda: pmesh.make_mesh(num_devices=3))
    out["outdim_pp"] = outdim_pp_ranks(rank, payload["outdim_pp"])
    return out


# ---------------------------------------------------------------------------
# test_torch_modules: output-dimension and pipeline parallelism
# ---------------------------------------------------------------------------

def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _one_step(model, factory, fn_kw, step_kw):
    """One step of ``factory`` on ``model`` with its own Adam: (loss, the
    parameters after it)."""
    opt = masked_optimizer(model, 0.01)
    loss = factory(opt, **fn_kw)(model, **step_kw)
    return float(loss), named(model)


def _outdim_cases(payload, mesh):
    """The dim-axis cases of ``outdim_pp_ranks``."""
    out = {}
    for case in ("gauss4", "mc", "prop"):
        m = pickle.loads(payload[case])
        zs = payload[f"zs {case}"]
        out[f"outdim {case}"] = grads_of(m, lambda: pod.outdim_elbo(
            m, m.X_data, m.Y_data, None, mesh, zs=zs), mesh)
        placed = pod.outdim_shard(m, mesh)
        local = pod._dim_params(placed, "dim")
        out[f"outdim {case} placed"] = grads_of(
            placed, lambda: pod.outdim_elbo(placed, m.X_data, m.Y_data,
                                            None, mesh, zs=zs),
            mesh, local=local)
    m = pickle.loads(payload["gauss4"])
    out["outdim specs gauss4"] = pod.outdim_specs(m)
    out["outdim specs mc"] = pod.outdim_specs(pickle.loads(payload["mc"]))
    with torch.no_grad():
        out["outdim seed"] = float(pod.outdim_elbo(m, m.X_data, m.Y_data, 5,
                                                   mesh))
    # one step on the placed model; the model it was placed from stays
    # as it was, and a step on the whole model keeps its structure
    zs = payload["zs gauss4"]
    before = named(m)
    placed = pod.outdim_shard(m, mesh)
    out["outdim step placed"] = _one_step(
        placed, pod.make_outdim_train_step, dict(mesh=mesh),
        dict(X=m.X_data, Y=m.Y_data, zs=zs))
    out["outdim placed shapes"] = {
        n: tuple(p.shape) for n, p in placed.named_parameters()}
    out["outdim original unchanged"] = all(
        np.array_equal(v, before[n]) for n, v in named(m).items())
    out["outdim step whole"] = _one_step(
        m, pod.make_outdim_train_step, dict(mesh=mesh),
        dict(X=m.X_data, Y=m.Y_data, zs=zs))
    out["outdim whole structure"] = [
        (layer.num_outputs_, type(layer.mean_function).__name__,
         tuple(layer.q_mu.unconstrained.shape)) for layer in m.layers]
    odd = pickle.loads(payload["odd"])
    out["outdim odd"] = error_of(lambda: pod.outdim_elbo(
        odd, odd.X_data, odd.Y_data, 0, mesh))
    flag = pickle.loads(payload["flag"])
    out["elbo_3d S=1"] = error_of(lambda: pod.elbo_3d(
        flag, flag.X_data, flag.Y_data, 0,
        _mesh((1, 2, 1), ("data", "sample", "dim"))))
    return out


def _pp_cases(payload, mesh):
    """The stage-axis cases of ``outdim_pp_ranks``."""
    out = {}
    m4 = pickle.loads(payload["pp4"])
    with torch.no_grad():
        out["pp 2 a stage"] = float(ppp.pp_elbo(
            ppp.pp_stack(m4), m4.X_data, m4.Y_data, None, mesh, n_micro=8,
            zs=payload["zs pp4"]))
        mk = pickle.loads(payload["keyed"])
        out["pp keyed"] = float(ppp.pp_elbo(
            ppp.pp_stack(mk), mk.X_data, mk.Y_data, 7, mesh, n_micro=3))
    for case, split in (("pp4", False), ("flag", True)):
        m = pickle.loads(payload[case])
        zs = payload[f"zs {case}"]
        ms = ppp.pp_stack(m, split_final=split)
        out[f"pp {case}"] = grads_of(ms, lambda: ppp.pp_elbo(
            ms, m.X_data, m.Y_data, None, mesh, n_micro=2, zs=zs), mesh)
        placed = ppp.pp_shard(ms, mesh)
        out[f"pp {case} placed"] = grads_of(
            placed, lambda: ppp.pp_elbo(placed, m.X_data, m.Y_data, None,
                                        mesh, n_micro=2, zs=zs),
            mesh, local=ppp._stage_params(placed))
        ms.remat = True
        out[f"pp {case} remat"] = grads_of(ms, lambda: ppp.pp_elbo(
            ms, m.X_data, m.Y_data, None, mesh, n_micro=2, zs=zs), mesh)
        out[f"pp {case} specs"] = ppp.pp_specs(ms)
    m = pickle.loads(payload["flag"])
    placed = ppp.pp_shard(ppp.pp_stack(m, split_final=True), mesh)
    out["pp placed shapes"] = {n: tuple(p.shape)
                               for n, p in placed.named_parameters()}
    out["pp step placed"] = _one_step(
        placed, ppp.make_pp_train_step, dict(mesh=mesh, n_micro=2),
        dict(X=m.X_data, Y=m.Y_data, zs=payload["zs flag"]))
    m = pickle.loads(payload["pp4"])
    ms = ppp.pp_stack(m)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.no_grad():
            ppp.pp_elbo(ms, m.X_data, m.Y_data, None, mesh, n_micro=2,
                        zs=payload["zs pp4"])
            n_warned = len(caught)
            ppp.pp_elbo(ms, m.X_data, m.Y_data, None, mesh, n_micro=4,
                        zs=payload["zs pp4"])
    out["pp bubble warnings"] = ([str(w.message) for w in caught], n_warned)
    m3 = pickle.loads(payload["pp3"])
    out["pp L=3"] = error_of(lambda: ppp.pp_elbo(
        ppp.pp_stack(m3), m3.X_data, m3.Y_data, None, mesh))
    x = torch.arange(6.0).reshape(3, 2) + 10 * pmesh.axis_index(mesh,
                                                                "stage")
    x.requires_grad_()
    y = pmesh.shift(x, mesh, "stage")
    (g,) = torch.autograd.grad(torch.sum(y * (1 + y)), x)
    out["shift"] = (np_(y), np_(g))
    return out


def outdim_pp_ranks(rank, payload):
    """2 ranks: ``outdim_elbo`` (Gaussian, MultiClass, input propagation;
    whole and placed models; values and gradients; seeded draws), specs,
    a step on the placed and on the whole model, the asserts; on a stage
    mesh ``pp_elbo`` (2 layers a stage, seeded draws, whole and placed,
    plain and split-final, remat; values and
    gradients), specs, a step on a placed model, the bubble warning and
    the refusals, and :func:`shift` itself."""
    with warnings.catch_warnings():
        # pp_elbo's bubble warning at n_micro=2, checked where it is wanted
        warnings.simplefilter("ignore", UserWarning)
        out = _outdim_cases(payload, _mesh((2,), ("dim",)))
        out.update(_pp_cases(payload, _mesh((2,), ("stage",))))
    return out


def outdim_pp_mesh4_ranks(rank, payload):
    """4 ranks: ``outdim_elbo`` over a dim axis of 4; ``elbo_2d`` on
    (data 2 x dim 2), Gaussian and MultiClass, and a step of
    ``make_2d_train_step`` on the placed model; ``elbo_3d`` on (data 2 x
    sample 1 x dim 2) and (1 x 2 x 2) and a ``make_3d_train_step`` step on
    the whole model; ``pp_elbo`` and a ``make_pp_train_step`` step on a
    placed model on (data 2 x stage 2)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return _mesh4_cases(payload)


def _mesh4_cases(payload):
    out = {}
    m = pickle.loads(payload["gauss4"])
    zs = payload["zs gauss4"]
    dd = _mesh((2, 2), ("data", "dim"))
    with torch.no_grad():
        out["dim4"] = float(pod.outdim_elbo(
            m, m.X_data, m.Y_data, None, _mesh((4,), ("dim",)), zs=zs))
        for case in ("gauss4", "mc"):
            mc = pickle.loads(payload[case])
            out[f"2d {case}"] = float(pod.elbo_2d(
                mc, mc.X_data, mc.Y_data, None, dd, zs=payload[f"zs {case}"]))
    out["2d step placed"] = _one_step(
        pod.outdim_shard(m, dd), pod.make_2d_train_step, dict(mesh=dd),
        dict(X=m.X_data, Y=m.Y_data, zs=zs))
    for case, shape in (("gauss4", (2, 1, 2)), ("mc", (1, 2, 2))):
        mc = pickle.loads(payload[case])
        mesh3 = _mesh(shape, ("data", "sample", "dim"))
        with torch.no_grad():
            out[f"3d {case}"] = float(pod.elbo_3d(
                mc, mc.X_data, mc.Y_data, None, mesh3,
                zs=payload[f"zs {case}"]))
        if case == "gauss4":
            out["3d step whole"] = _one_step(
                mc, pod.make_3d_train_step, dict(mesh=mesh3),
                dict(X=mc.X_data, Y=mc.Y_data, zs=zs))
    ds = _mesh((2, 2), ("data", "stage"))
    m = pickle.loads(payload["pp4"])
    with torch.no_grad():
        out["pp data"] = float(ppp.pp_elbo(
            ppp.pp_stack(m), m.X_data, m.Y_data, None, ds, n_micro=2,
            data_axis="data", zs=payload["zs pp4"]))
    out["pp data step placed"] = _one_step(
        ppp.pp_shard(ppp.pp_stack(m), ds), ppp.make_pp_train_step,
        dict(mesh=ds, n_micro=2, data_axis="data"),
        dict(X=m.X_data, Y=m.Y_data, zs=payload["zs pp4"]))
    out["coords"] = (pmesh.axis_index(dd, "data"),
                     pmesh.axis_index(dd, "dim"))
    return out


# ---------------------------------------------------------------------------
# test_torch_paths: the steps, fit_dp, predictions and evaluation against
# the port's single-process functions
# ---------------------------------------------------------------------------

def _scan_chunk(model, mesh, seed, **kw):
    opt = masked_optimizer(model, 0.01)
    chunk = pdp.make_dp_scan_train_step(opt, mesh, **kw)
    rec = Recorder(pmesh.rank_generator(seed, pmesh.axis_index(mesh, "data"),
                                        "cpu"))
    loss = chunk(model, rec)
    return float(loss), named(model), rec.draws, chunk.dispatch


def paths_ranks(rank, payload):
    """2 ranks: a chunk of ``make_dp_scan_train_step`` (plain, guarded,
    ``grad_inside=False``) with its draws, one step of
    ``make_dp_train_step`` and of ``make_dp_natgrad_adam_step`` at fixed
    draws, ``fit_dp`` (with its history, a checkpoint resume and a data x
    sample mesh), the predictions and evaluations, and the refusals and
    warnings."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = pmesh.make_mesh()
    fresh = lambda: pickle.loads(payload["model"])            # noqa: E731
    out = {}
    for case, kw in (("plain", {}),
                     ("guarded", dict(reject_nonfinite=True)),
                     ("grad outside", dict(grad_inside=False))):
        out[f"scan {case}"] = _scan_chunk(fresh(), mesh, 11,
                                          batch_size=payload["batch"],
                                          inner_steps=2, **kw)
    m = fresh()
    opt = masked_optimizer(m, 0.01)
    loss = pdp.make_dp_train_step(opt, mesh)(
        m, payload["X_b"], payload["Y_b"], zs=payload["zs_b"])
    out["train step"] = (float(loss), named(m))
    m = fresh()
    opt = masked_optimizer(m, 0.01, freeze=freeze_q_params((-1,), 2))
    step = pdp.make_dp_natgrad_adam_step(opt, 0.1, mesh)
    loss = step(m, payload["X_b"], payload["Y_b"],
                zs=(payload["zs_b"], payload["zs_b2"]))
    out["natgrad step"] = (float(loss), named(m), int(step.rejected))

    m = fresh()
    _, hist = port.fit_dp(m, mesh, 3, batch_size=payload["batch"], seed=4,
                          log_every=1, scan_steps=1)
    out["fit_dp"] = (named(m), hist)
    d = payload["ckpt_dir"]
    m = fresh()
    port.fit_dp(m, mesh, 2, batch_size=payload["batch"], seed=4,
                log_every=1, scan_steps=1, ckpt_dir=d, ckpt_every=2)
    m = fresh()
    port.fit_dp(m, mesh, 3, batch_size=payload["batch"], seed=4,
                log_every=1, scan_steps=1, ckpt_dir=d, ckpt_every=2)
    out["fit_dp resumed"] = named(m)
    samples = init_device_mesh("cpu", (1, 2),
                               mesh_dim_names=("data", "sample"))
    m = fresh()
    port.fit_dp(m, samples, 2, batch_size=payload["batch"], seed=6,
                axis="data", sample_axis="sample", log_every=2,
                scan_steps=2)
    out["fit_dp sample axis"] = named(m)

    m = fresh()
    Xs, Ys = payload["Xs"], payload["Ys"]
    S = payload["S"]
    out["predict_y zs"] = tuple(map(np_, pdp.dp_predict_y(
        m, Xs, S, None, mesh, zs=payload["zs_pred"])))
    out["predict_y seed"] = tuple(map(np_, pdp.dp_predict_y(
        m, Xs, S, 9, mesh)))
    out["predict_density zs"] = np_(pdp.dp_predict_density(
        m, Xs, Ys, S, None, mesh, zs=payload["zs_pred"]))
    out["evaluate_regression"] = pdp.dp_evaluate_regression(
        m, Xs, Ys, payload["Y_std"], S, None, mesh, zs=payload["zs_eval"])
    out["evaluate_regression seed"] = pdp.dp_evaluate_regression(
        m, Xs, Ys, payload["Y_std"], S, 2, mesh)
    c = pickle.loads(payload["classifier"])
    out["evaluate_classification"] = pdp.dp_evaluate_classification(
        c, payload["Xc"], payload["Yc"], S, None, mesh, zs=payload["zs_c"])

    out["fit_dp collapsed"] = error_of(lambda: port.fit_dp(
        pickle.loads(payload["collapsed"]), mesh, 1))
    out["fit_dp odd N"] = error_of(lambda: port.fit_dp(
        pickle.loads(payload["odd"]), mesh, 1))
    out["sp_elbo S=3"] = error_of(lambda: port.sp_elbo(
        pickle.loads(payload["s3"]), Xs, Ys, 0,
        init_device_mesh("cpu", (2,), mesh_dim_names=("sample",))))
    out["dp_predict_y S=3"] = error_of(lambda: pdp.dp_predict_y(
        m, Xs, 3, 0, mesh))
    out["guard grad outside"] = error_of(lambda: pdp.make_dp_scan_train_step(
        masked_optimizer(m, 0.01), mesh, grad_inside=False,
        reject_nonfinite=True))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port.fit_dp(fresh(), mesh, 2, batch_size=payload["batch"],
                    scan_steps=2, reject_nonfinite=True)
        port.fit_dp(fresh(), samples, 2, batch_size=payload["batch"],
                    sample_axis="sample", scan_steps=8,
                    reject_nonfinite=True)
    out["warnings"] = [str(w.message) for w in caught]
    return out


def fit_one_rank(rank, payload):
    """1 rank: ``fit_dp`` (plain and guarded) for the comparison with
    ``fit``, bit for bit."""
    mesh = pmesh.make_mesh()
    out = {}
    for guard in (False, True):
        m = pickle.loads(payload["model"])
        _, hist = port.fit_dp(m, mesh, 16, batch_size=payload["batch"],
                              seed=3, log_every=8, reject_nonfinite=guard)
        out[guard] = (named(m), [h["loss"] for h in hist])
    return out



def mnist_demo_ranks(rank, payload):
    """2 ranks: ``demos_torch/mnist.py --data-parallel`` in their group
    (``fit_dp`` over both), from the data handed over; the summary."""
    from demos_torch import mnist
    return mnist.run(mnist.parse_args(payload["argv"]), payload["data"])[0]
