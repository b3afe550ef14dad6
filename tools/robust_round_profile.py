"""Where a server round's time goes under a Byzantine adversary and a
robust rule, at sparse-10k (10⁴ agents, MLP 784-32-10, a random 4-regular
graph, p = 0.05): one gossip round and the first server round of
``adversary="signflip:f=0.2"`` with each server rule (mean, trimmed,
median, krum), traced with ``torch.profiler`` on the card.  Prints per
round kind the host milliseconds, the device-busy milliseconds and the
heaviest device operations of the server round.

    python3 tools/robust_round_profile.py            # on a machine with the card
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke as cs
    from repro_torch.core import Experiment, ExperimentSpec
    from repro_torch.data import FederatedDataset, RoundSampler
    from repro_torch.data.synthetic import synthetic_mnist
    from repro_torch.device import resolve_device
    from repro_torch.models import simple as models

    dev = resolve_device("cuda")
    n = cs.SIZES["sparse_agents"]
    x, y = synthetic_mnist(n * 20, seed=0)
    data = FederatedDataset.from_arrays(x, y, n_agents=n).to(dev)
    base = ExperimentSpec.create(
        algo="pisco", n_agents=n, t_o=2, eta_l=0.1, p=0.05, seed=0, topology="random_regular",
        topology_kwargs={"degree": 4}, sparse=True, adversary="signflip:f=0.2")
    k = cs.first_server_round(base)
    cs.log(f"first server round at k = {k}; {torch.cuda.get_device_name(0)}")
    for rule in ("mean", "trimmed", "median", "krum"):
        spec = base.replace(robust_agg=rule, rounds=k + 1, eval_every=k + 1)

        def run(sampler_hook):
            def factory(s):
                inner = RoundSampler(data, 16, s.config.t_o, s.config.seed, device=dev)

                def sampler(r):
                    torch.cuda.synchronize()
                    sampler_hook(r)
                    return inner(r)

                return sampler

            hist = Experiment(spec, loss_fn=models.mlp_loss, params0=models.mlp_init(0),
                              sampler_factory=factory, device=dev).run()
            torch.cuda.synchronize()
            return hist

        # host milliseconds per round, untraced: the sampler of round r + 1
        # (or the run's end) closes round r
        marks = {}
        hist = run(lambda r: marks.__setitem__(r, time.perf_counter()))
        marks[k + 1] = time.perf_counter()
        cs.check(hist.is_global[k] and not any(hist.is_global[:k]), "window: server at k")
        host = {r: 1e3 * (marks[r + 1] - marks[r]) for r in range(k + 1)}
        # the server round alone under the profiler: steps are set-up, the
        # init probe sampler(-1), then one per round, so round k is step k + 2
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=k + 1, warmup=1, active=1, repeat=1)) as prof:
            run(lambda r: prof.step())
        window, busy, top = cs.device_share(prof, f"robust-{rule}")
        cs.log(f"rule {rule}: host ms per round {host} (round {k} the server round); "
               f"server round traced: device busy {busy / 1e3:.3f} of {window / 1e3:.3f} ms")
        for name, us in top[:8]:
            cs.log(f"rule {rule}:   {us / 1e3:8.3f} ms  {name[:100]}")
        del hist, prof


if __name__ == "__main__":
    main()
