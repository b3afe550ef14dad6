"""Quickstart: PISCO through the ExperimentSpec API (twin of
``examples/quickstart.py``).

Federated nonconvex logistic regression over a ring of 10 agents with a
probabilistic server (p = 0.1), gradient tracking and T_o = 5 local
updates, on the GPU (``--device cpu`` to opt out), then a 3-seed sweep and
FedAdam over gossip (local momentum, server Adam: two more spec fields).

    python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import functools

import torch

from repro_torch.core import Experiment, ExperimentSpec
from repro_torch.data import FederatedDataset, RoundSampler
from repro_torch.data.synthetic import synthetic_a9a
from repro_torch.device import resolve_device
from repro_torch.models.simple import logreg_accuracy, logreg_loss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. Federated data: sorted-label split (extreme heterogeneity, paper §5),
    #    resident on the device
    x, y = synthetic_a9a(8000, seed=0)
    data = FederatedDataset.from_arrays(x, y, n_agents=10, heterogeneous=True).to(dev)

    # 2. One declarative spec: algorithm (any registry entry), topology,
    #    PiscoConfig, round budget, eval policy, driver.
    spec = ExperimentSpec.create(
        algo="pisco", n_agents=10, t_o=5, eta_l=0.3, eta_c=1.0, p=0.1, seed=0,
        topology="ring", rounds=100, eval_every=10, driver="scan",
    )
    print("spec:", spec.to_json())

    # 3. Bind the problem pieces and run
    loss_fn = functools.partial(logreg_loss, rho=0.01)
    x_all = data.x_train.reshape(-1, data.x_train.shape[-1])
    y_all = data.y_train.reshape(-1)

    def eval_fn(params):
        # metrics at the agent-average parameters x-bar (the paper's readout)
        acc = logreg_accuracy(params, data.x_test, data.y_test)
        gl = loss_fn(params, (x_all, y_all))
        host = torch.stack([acc, gl]).cpu()
        return {"test_acc": float(host[0]), "global_loss": float(host[1])}

    exp = Experiment(
        spec,
        loss_fn=loss_fn,
        params0={"w": torch.zeros(x.shape[1])},
        sampler_factory=lambda s: RoundSampler(
            data, batch_size=128, t_o=s.config.t_o, seed=s.config.seed, device=dev
        ),
        eval_fn=eval_fn,
        device=dev,
    )
    hist = exp.run()

    # 4. Report
    print(
        f"global loss at x-bar: {hist.eval_metrics[0]['global_loss']:.4f} -> "
        f"{hist.eval_metrics[-1]['global_loss']:.4f}"
    )
    print(f"test accuracy: {hist.eval_metrics[-1]['test_acc']:.3f}")
    print(
        f"communication: {hist.accountant.agent_to_agent} cheap gossip rounds, "
        f"{hist.accountant.agent_to_server} server rounds"
    )

    # 5. Multi-seed confidence: every seed advances through one Bernoulli(p)
    #    schedule, each with its own minibatch stream.
    hists = exp.sweep(seeds=[0, 1, 2])
    accs = [h.eval_metrics[-1]["test_acc"] for h in hists]
    print(f"3-seed test acc: {min(accs):.3f} .. {max(accs):.3f}")

    # 6. Pluggable update rules: FedAdam over gossip — local momentum on the
    #    tracker, server-side Adam at the Bernoulli(p) server rounds.  Same
    #    spec, two more declarative fields.
    fed_spec = spec.replace(optimizer="momentum:lr=0.1", server_optimizer="fedadam")
    fed_hist = Experiment(
        fed_spec,
        loss_fn=loss_fn,
        params0={"w": torch.zeros(x.shape[1])},
        sampler_factory=lambda s: RoundSampler(
            data, batch_size=128, t_o=s.config.t_o, seed=s.config.seed, device=dev
        ),
        eval_fn=eval_fn,
        device=dev,
    ).run()
    print(
        f"FedAdam-over-gossip: global loss "
        f"{fed_hist.eval_metrics[0]['global_loss']:.4f} -> "
        f"{fed_hist.eval_metrics[-1]['global_loss']:.4f} "
        f"(acc {fed_hist.eval_metrics[-1]['test_acc']:.3f})"
    )
    return hist, hists, fed_hist


if __name__ == "__main__":
    main()
