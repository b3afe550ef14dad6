"""The port's twin of conftest's ``make_logreg_problem``: a tiny federated
logistic regression with a sorted-label split, as torch tensors on the CPU."""
import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def make_logreg_problem(n_agents=8, d=16, m=64, seed=0):
    """``(loss_fn, sampler_factory, d)``: ``sampler_factory(t_o, b=16,
    seed=1)`` gives a sampler drawing each round's batches from its own
    numpy generator, as the reference's does."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=d)
    x = rng.normal(size=(n_agents * m, d))
    y = np.where(x @ w_true + 0.2 * rng.normal(size=len(x)) > 0, 1.0, -1.0)
    order = np.argsort(y, kind="stable")
    x = x[order].reshape(n_agents, m, d).astype(np.float32)
    y = y[order].reshape(n_agents, m).astype(np.float32)

    def loss_fn(params, batch):
        a, lab = batch
        return torch.mean(torch.log1p(torch.exp(-lab * (a @ params["w"]))))

    def sampler_factory(t_o, b=16, seed=1):
        srng = np.random.default_rng(seed)

        def sampler(k):
            idx = srng.integers(0, m, size=(t_o + 1, n_agents, b))
            xb = _t(np.take_along_axis(x[None], idx[..., None], axis=2))
            yb = _t(np.take_along_axis(y[None], idx, axis=2))
            return (xb[:t_o], yb[:t_o]), (xb[-1], yb[-1])

        return sampler

    return loss_fn, sampler_factory, d
