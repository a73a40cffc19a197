"""Faults planted under the timed path, to show that ``correct`` catches
them: each replaces an entry point of the port with a broken wrapper of
it (install with ``plant``).  A cell on one chip has no exchange between
chips to leave out."""

from __future__ import annotations

import torch


def state_unchanged(loop):
    """Chunks that take their steps and then put the parameters back: a
    step that returns its state unchanged."""
    make = loop.make_scan_train_step

    def make_scan_train_step(optimizer, *args, **kwargs):
        chunk = make(optimizer, *args, **kwargs)

        def frozen(model, generator=None):
            saved = [p.detach().clone() for p in optimizer.params]
            loss = chunk(model, generator=generator)
            with torch.no_grad():
                for p, s in zip(optimizer.params, saved):
                    p.copy_(s)
            return loss
        return frozen
    return make_scan_train_step


def half_batch(dgp):
    """The objective on the first half of each batch, the mean taken over
    it (the ELBO scales by num_data over the rows it sees)."""
    elbo = dgp.elbo

    def half(self, X=None, Y=None, generator=None, zs=None):
        X = self.X_data if X is None else X
        Y = self.Y_data if Y is None else Y
        n = X.shape[0] // 2
        return elbo(self, X[:n], Y[:n], generator=generator, zs=zs)
    return half


def altered_answer(port):
    """A server whose every answer has one value changed by 1e-3 where it
    is produced."""
    make = port.make_server

    def make_server(*args, **kwargs):
        serve = make(*args, **kwargs)

        def altered(X, *a, **k):
            mean, var = serve(X, *a, **k)
            mean = mean.clone()
            mean.view(-1)[0] += 1e-3
            return mean, var
        return altered
    return make_server


def _loop():
    from doubly_stochastic_dgp_tpu_torch.training import loop
    return loop


def _dgp():
    from doubly_stochastic_dgp_tpu_torch import DGP
    return DGP


def _port():
    import doubly_stochastic_dgp_tpu_torch as port
    return port


# name: (the object whose attribute it replaces, the attribute, the
# wrapper of the attribute's owner, the traffic kind it breaks)
FAULTS = {"state_unchanged": (_loop, "make_scan_train_step",
                              state_unchanged, "train"),
          "half_batch": (_dgp, "elbo", half_batch, "train"),
          "altered_answer": (_port, "make_server", altered_answer, "serve")}


def plant(name, setattr_=setattr):
    """Installs fault ``name`` (``setattr_``: a test's
    monkeypatch.setattr, which undoes it)."""
    owner, attr, wrap, _ = FAULTS[name]
    target = owner()
    setattr_(target, attr, wrap(target))
