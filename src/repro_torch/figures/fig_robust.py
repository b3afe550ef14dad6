"""How many Byzantine agents can PISCO survive?  The port's twin of
``benchmarks/fig_robust.py``.

The §5.1 logreg workload on the iid split over n = 16 agents, of which
ceil(0.2 n) = 4 flip the sign of every payload they send
(``adversary="signflip:f=0.2"``) while the honest twelve run PISCO
unchanged.  A clean phase first trains the fleet to a warm iterate; the
Byzantine agents then switch on.  At p = 1 (every round a server round) the
server rule is the defense:

* plain mean: four flipped uploads contract the aggregate each round;
* trimmed mean (``robust_agg="trimmed"``) drops them as outliers, and the
  final loss stays within 10% of the clean continuation: the robustness
  flip ``BENCH_robust.json`` records; the median matches it;
* Krum selects one agent's whole vector, whose batch noise then feeds the
  gradient tracker every round: a negative result;
* at p = 0.1 (trimmed) the corruption reaches the honest agents through
  gossip between server rounds, which the server rule never sees.

The origin-trap row attacks the zero init, where every symmetric rule
halves the mean each round and the model locks at the origin.

On the card the rounds run K1 for the local steps; the sign flip is folded
into the ring's W (``torch.matmul`` gossip) and the server rule runs in
plain torch over the 16 uploads.

Writes ``BENCH_robust.json`` (``artifacts/torch/`` by default).

    python -m repro_torch.figures.fig_robust [--quick] [--device cpu]
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.data import FederatedDataset
from repro_torch.data.synthetic import synthetic_a9a
from repro_torch.device import resolve_device
from repro_torch.figures.common import Tally, run_pisco_variant, save_result
from repro_torch.models import simple as S
from repro_torch.sim.tuner import _smoothed

N_AGENTS = 16
ADVERSARY = "signflip:f=0.2"  # ceil(0.2 * 16) = 4 Byzantine agents

ROWS = (
    # (label, adversary, robust_agg, p)
    ("clean", None, "mean", 1.0),
    ("signflip+mean", ADVERSARY, "mean", 1.0),
    ("signflip+trimmed", ADVERSARY, "trimmed", 1.0),
    ("signflip+median", ADVERSARY, "median", 1.0),
    ("signflip+krum", ADVERSARY, "krum", 1.0),
    ("signflip+trimmed@p0.1", ADVERSARY, "trimmed", 0.1),
)


def make_iid_workload(quick: bool, seed: int, device):
    """Logreg on the iid partition, the data resident on ``device``."""
    n_samples = 4000 if quick else 32560
    x, y = synthetic_a9a(n_samples, seed=seed)
    data = FederatedDataset.from_arrays(x, y, N_AGENTS, heterogeneous=False,
                                        seed=seed).to(device)
    loss_fn = functools.partial(S.logreg_loss, rho=0.01)

    def eval_fn(params):
        return {"test_acc": float(S.logreg_accuracy(params, data.x_test, data.y_test))}

    return data, loss_fn, eval_fn, {"w": torch.zeros((x.shape[1],), dtype=torch.float32,
                                                     device=device)}


def _readout(hist, window: int) -> dict:
    series = _smoothed(hist.loss, window)
    out = {
        "rounds": len(hist.loss),
        "final_loss": float(series[-1]),
        "final_test_acc": float(hist.eval_metrics[-1]["test_acc"]),
        "adversary_mask": hist.adversary_mask,
        "total_bytes": int(hist.accountant.total_bytes),
    }
    if hist.eval_per_agent:
        last = hist.eval_per_agent[-1]
        out["final_honest_test_acc"] = float(last["honest_test_acc"])
        out["final_byz_test_acc"] = float(last["byz_test_acc"])
    return out


def run(quick: bool = False, seed: int = 0, device=None, out_dir=None) -> dict:
    dev = resolve_device(device)
    tally = Tally(dev)
    rounds = 100 if quick else 300
    window = max(1, min(20, rounds // 10))
    data, loss_fn, eval_fn, params0 = make_iid_workload(quick, seed, dev)
    common = dict(data=data, loss_fn=loss_fn, eval_fn=eval_fn, t_o=2, rounds=rounds,
                  device=dev)

    # phase 1: clean pretraining to a warm iterate (the model under attack)
    h_warm, _ = run_pisco_variant(params0=params0, p=1.0, eta_l=0.1, seed=seed,
                                  eval_every=rounds, **common)
    tally.add(h_warm)
    warm = {k: v.mean(dim=0) for k, v in sorted(h_warm.final_state.x.items())}

    # phase 2: the Byzantine agents switch on; small steps keep the honest
    # noise floor below the flip separation
    rows = {}
    for label, adversary, robust_agg, p in ROWS:
        hist, _ = run_pisco_variant(params0=warm, p=p, eta_l=0.02, seed=seed + 1,
                                    eval_every=max(1, rounds // 4), adversary=adversary,
                                    robust_agg=robust_agg, **common)
        tally.add(hist)
        rows[label] = _readout(hist, window)

    # the degenerate regime for the record: attacking the zero init
    h_trap, _ = run_pisco_variant(params0=params0, p=1.0, eta_l=0.1, seed=seed,
                                  eval_every=rounds, adversary=ADVERSARY,
                                  robust_agg="trimmed", **common)
    tally.add(h_trap)

    clean = rows["clean"]["final_loss"]
    within = lambda row: rows[row]["final_loss"] <= 1.10 * clean  # noqa: E731
    payload = tally.stamp({
        "bench": "fig_robust",
        "quick": quick,
        "n_agents": N_AGENTS,
        "adversary": ADVERSARY,
        "n_byzantine": int(np.sum(rows["signflip+mean"]["adversary_mask"])),
        "warm_final_loss": float(_smoothed(h_warm.loss, window)[-1]),
        "rows": rows,
        "origin_trap": _readout(h_trap, window),
        "clean_final_loss": clean,
        "trimmed_within_10pct": bool(within("signflip+trimmed")),
        "mean_within_10pct": bool(within("signflip+mean")),
        "robustness_flip": bool(within("signflip+trimmed") and not within("signflip+mean")),
    })
    save_result("BENCH_robust", payload, out_dir, device=dev)
    return payload


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    payload = run(quick=args.quick, device=args.device)
    clean = payload["clean_final_loss"]
    print(f"n={payload['n_agents']}, adversary={payload['adversary']} "
          f"({payload['n_byzantine']} Byzantine), warm loss "
          f"{payload['warm_final_loss']:.4f}, clean final loss {clean:.4f}")
    print(f"{'variant':>24} | {'final loss':>10} | {'vs clean':>8} | {'test acc':>8}")
    for label, row in payload["rows"].items():
        ratio = row["final_loss"] / max(clean, 1e-12)
        print(f"{label:>24} | {row['final_loss']:10.4f} | {ratio:8.2f}x | "
              f"{row['final_test_acc']:8.3f}")
    trap = payload["origin_trap"]
    print(f"{'origin trap (cold init)':>24} | {trap['final_loss']:10.4f} | {'---':>8} | "
          f"{trap['final_test_acc']:8.3f}")
    print(f"robustness flip (trimmed within 10%, mean not): {payload['robustness_flip']}")


if __name__ == "__main__":
    main()
