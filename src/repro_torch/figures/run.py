"""Figure harness of the port (twin of ``benchmarks/run.py``): one CSV row
``name,seconds,derived`` per figure, with the reference's derived strings.

    python -m repro_torch.figures.run [--full] [--only fig4 ...] [--out DIR] [--device cpu]

Quick sizes by default; ``--full`` runs the paper's.  ``ablation`` is opt-in,
as in the reference.  ``timecost`` and ``async`` (simulated wall-clock and
asynchronous execution) run with the rest.  A figure whose subsystem is not
ported (``robust``, ``serve``, ``roofline``, ``driver``) raises an error
naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.device import resolve_device

PORTED = ("fig4", "fig5", "fig6", "fig7", "table2", "compression", "dynamic", "optimizers",
          "timecost", "async", "ablation", "sparse")
# the reference's other figures -> the ROADMAP item that ports them
NOT_PORTED = {"robust": "A12", "serve": "A16", "roofline": "A17", "driver": "A13"}
OPT_IN = ("ablation",)


def _row(name: str, seconds: float, derived: str) -> None:
    print(f"{name},{seconds:.2f},{derived}", flush=True)


def _fig4(quick, dev, out):
    from repro_torch.figures import fig4_p_sweep

    res = fig4_p_sweep.run(quick=quick, device=dev, out_dir=out)["results"]
    p0 = next((v for k, v in res.items() if k.startswith("p=0.0000")), None)
    pm = min(
        (v for k, v in res.items() if not k.startswith("p=0.0000") and v["train"]),
        key=lambda v: v["train"]["rounds"],
        default=None,
    )
    p1 = res.get("p=1.0000")
    if p0 and p0["train"] and pm:
        saving = 1.0 - pm["train"]["a2a"] / max(1.0, p0["train"]["a2a"])
        return f"a2a_savings_vs_p0={saving:.0%}"
    if pm and p1 and p1["train"]:
        # p = 0 never reached the target (the strongest form of the claim)
        return (f"p0_never_reached;best_semi_a2s={pm['train']['a2s']:.0f}"
                f";p1_a2s={p1['train']['a2s']:.0f}")
    return "n/a"


def _fig5(quick, dev, out):
    from repro_torch.figures import fig5_local_updates

    res = fig5_local_updates.run(quick=quick, device=dev, out_dir=out)["results"]
    r1 = res.get("T_o=1,p=0.1000", {}).get("train_rounds")
    r10 = res.get("T_o=10,p=0.1000", {}).get("train_rounds")
    return f"rounds_T1={r1:.0f};rounds_T10={r10:.0f}" if r1 and r10 else "n/a"


def _fig6(quick, dev, out):
    from repro_torch.figures import fig6_topology

    res = fig6_topology.run(quick=quick, device=dev, out_dir=out)["results"]
    dis0 = res.get("er_disconnected,p=0.0000", {}).get("final_train_loss")
    dis1 = res.get("er_disconnected,p=0.1000", {}).get("final_train_loss")
    return f"disc_loss_p0={dis0:.3f};p0.1={dis1:.3f}" if dis0 and dis1 else "n/a"


def _fig7(quick, dev, out):
    from repro_torch.figures import fig7_cnn

    res = fig7_cnn.run(quick=quick, device=dev, out_dir=out)["results"]
    return ";".join(f"{k}={v['final_test_acc']:.2f}" for k, v in res.items())


def _compression(quick, dev, out):
    from repro_torch.figures import fig_compression

    res = fig_compression.run(quick=quick, device=dev, out_dir=out)["results"]
    saving = fig_compression.best_same_p_savings(res)
    return f"gossip_byte_savings_vs_fp32={saving:.1f}x" if saving else "n/a"


def _dynamic(quick, dev, out):
    from repro_torch.figures import fig_dynamic

    saving = fig_dynamic.run(quick=quick, device=dev, out_dir=out)["participation_byte_savings"]
    return f"server_byte_savings_half_part={saving:.2f}x" if saving else "n/a"


def _optimizers(quick, dev, out):
    from repro_torch.figures import fig_optimizers

    s = fig_optimizers.run(quick=quick, device=dev, out_dir=out)["best_adaptive_speedup"]
    return f"best_adaptive_speedup={s:.2f}x" if s else "n/a"


def _timecost(quick, dev, out):
    from repro_torch.figures import fig_timecost

    flip = fig_timecost.tuner_flip(
        fig_timecost.run(quick=quick, device=dev, out_dir=out)["profiles"])
    return f"best_p_lan={flip[0]:g};best_p_wan={flip[1]:g}" if flip else "n/a"


def _async(quick, dev, out):
    from repro_torch.figures import fig_async

    payload = fig_async.run(quick=quick, device=dev, out_dir=out)
    speed = fig_async.async_flip(payload["profiles"])
    return (f"free_bit_identical={payload['profiles']['free']['bit_identical_loss']}"
            + "".join(f";{k}_speedup={v:.2f}x" for k, v in speed.items() if k != "free"))


def _table2(quick, dev, out):
    from repro_torch.figures import table2_complexity

    nd = table2_complexity.run(quick=quick, out_dir=out)["network_dependency"]
    r = next(x for x in nd
             if x["lambda_w"] == 1e-4 and 0 < x["p"] < 1 and x["p"] > x["lambda_w"])
    return f"lam1e-4_sqrtp_dependency={r['network_term']:.1e}"


def _ablation(quick, dev, out):
    from repro_torch.figures import ablation_eta_c

    res = ablation_eta_c.run(quick=quick, device=dev, out_dir=out)["results"]
    return f"best_grad_sq={min(v['final_grad_sq'] for v in res.values()):.2e}"


def _sparse(quick, dev, out):
    from repro_torch.figures import fig_sparse

    payload = fig_sparse.run(quick=quick, device=dev, out_dir=out)
    ratio = fig_sparse.memory_ratio(payload["results"])
    biggest = max(payload["results"].values(), key=lambda r: r["n_agents"])
    return (f"mem_savings_n{biggest['n_agents']}={ratio:.0f}x"
            f";per_round_ms={biggest['per_round_s'] * 1e3:.1f}"
            f";parity_n{payload['parity']['n']}={payload['parity']['ok']}")


# run order and CSV row names, as in the reference
FIGURES = (
    ("fig4", "fig4_p_sweep", _fig4),
    ("fig5", "fig5_local_updates", _fig5),
    ("fig6", "fig6_topology", _fig6),
    ("fig7", "fig7_cnn", _fig7),
    ("compression", "fig_compression", _compression),
    ("dynamic", "fig_dynamic", _dynamic),
    ("optimizers", "fig_optimizers", _optimizers),
    ("timecost", "fig_timecost", _timecost),
    ("async", "fig_async", _async),
    ("table2", "table2_complexity", _table2),
    ("ablation", "ablation_eta_c", _ablation),
    ("sparse", "fig_sparse", _sparse),
)


def main(argv=None) -> None:
    known = PORTED + tuple(NOT_PORTED)
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="paper-scale settings")
    ap.add_argument("--only", nargs="*", default=None, help=f"subset of: {' '.join(known)}")
    ap.add_argument("--out", default=None, help="payload directory (default artifacts/torch)")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    only = set(args.only) if args.only else None
    if only is not None:
        unknown = only - set(known)
        if unknown:
            ap.error(f"unknown figure name(s): {' '.join(sorted(unknown))}; "
                     f"choose from: {' '.join(known)}")
        for name in sorted(only & set(NOT_PORTED)):
            raise NotImplementedError(
                f"figure {name!r} is not ported yet (ROADMAP {NOT_PORTED[name]})")
    dev = resolve_device(args.device)
    quick = not args.full
    print("name,seconds,derived", flush=True)
    for key, row, fn in FIGURES:
        if (only is None and key not in OPT_IN) or (only is not None and key in only):
            t0 = time.perf_counter()
            derived = fn(quick, dev, args.out)
            _row(row, time.perf_counter() - t0, derived)


if __name__ == "__main__":
    main()
