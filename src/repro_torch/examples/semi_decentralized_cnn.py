"""The paper's Fig. 7 workload as a runnable example (twin of
``examples/semi_decentralized_cnn.py``): the CNN on a sorted (CIFAR-like)
split over a 5-agent ring, comparing p in {0, 0.2, 1} with one grid sweep
over the ExperimentSpec API, on the GPU (``--device cpu`` to opt out).

    python -m repro_torch.examples.semi_decentralized_cnn --rounds 40
"""
import argparse

from repro_torch.core import Experiment, ExperimentSpec
from repro_torch.data import FederatedDataset, RoundSampler
from repro_torch.data.synthetic import synthetic_cifar
from repro_torch.device import resolve_device
from repro_torch.models.simple import cnn_accuracy, cnn_init, cnn_loss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--t-o", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    x, y = synthetic_cifar(3000, seed=0)
    data = FederatedDataset.from_arrays(x, y, 5, heterogeneous=True).to(dev)

    def eval_fn(params):
        return {"test_acc": float(cnn_accuracy(params, data.x_test, data.y_test))}

    spec = ExperimentSpec.create(
        algo="pisco", n_agents=5, t_o=args.t_o, eta_l=0.05, eta_c=1.0, p=0.0,
        seed=0, topology="ring", rounds=args.rounds,
        eval_every=max(1, args.rounds // 8), driver="scan",
    )
    exp = Experiment(
        spec,
        loss_fn=cnn_loss,
        # the port's own seeded draw (JAX's PRNG bits cannot be reproduced)
        params0=cnn_init(0),
        sampler_factory=lambda s: RoundSampler(
            data, batch_size=20, t_o=s.config.t_o, seed=s.config.seed, device=dev
        ),
        eval_fn=eval_fn,
        device=dev,
    )

    print(f"5-agent ring, sorted CIFAR-like split, T_o={args.t_o}")
    runs = exp.sweep(grid={"p": [0.0, 0.2, 1.0]})
    for run_spec, hist in runs:
        print(
            f"  p={run_spec.config.p:4.1f}: loss {hist.loss[0]:.3f} -> {hist.loss[-1]:.3f}, "
            f"test acc {hist.eval_metrics[-1]['test_acc']:.3f} "
            f"({hist.accountant.agent_to_server} server rounds)"
        )
    return runs


if __name__ == "__main__":
    main()
