"""Table 2 on the port (twin of ``benchmarks/table2_complexity.py``): the
expected agent-to-server / agent-to-agent communication rounds to reach
epsilon-accuracy, every algorithm's leading-order bound evaluated at
representative problem constants (analytic: plain numpy, no device).

    python -m repro_torch.figures.table2_complexity
"""
from __future__ import annotations

import numpy as np

from repro_torch.figures.common import save_result


def bounds(n, t_o, lam_w, p, sigma, eps):
    """Leading terms from Table 2 (L = 1, constants dropped)."""
    lam_p = lam_w + p * (1 - lam_w)
    scaffold_server = sigma**2 / (n * t_o * eps**4) + 1 / eps**2
    lsgt_a2a = (
        sigma**4 / (n * t_o * lam_w**8 * eps**4)
        + 1 / (n * t_o ** (1 / 3) * lam_w ** (8 / 3) * eps ** (4 / 3))
        + 1 / (n * t_o * eps**2)
        if lam_w > 0 else np.inf
    )
    periodical_gt_a2a = (
        sigma**2 / (n * t_o * eps**4) + sigma / (lam_w**2 * eps**3) + 1 / (lam_w**2 * eps**2)
        if lam_w > 0 else np.inf
    )
    k_gt_a2a = (
        sigma**2 / (n * t_o * eps**4)
        + sigma / (lam_w**2 * np.sqrt(t_o) * eps**3)
        + 1 / (lam_w**2 * eps**2)
        if lam_w > 0 else np.inf
    )
    pisco_total = (
        sigma**2 / (n * t_o * eps**4) + sigma / (lam_p**2 * eps**3) + 1 / (n * eps**2)
    )
    return {
        "SCAFFOLD (server)": scaffold_server,
        "LSGT (a2a)": lsgt_a2a,
        "Periodical-GT (a2a)": periodical_gt_a2a,
        "K-GT (a2a)": k_gt_a2a,
        "PISCO (server)": p * pisco_total,
        "PISCO (a2a)": (1 - p) * pisco_total,
        "PISCO (total)": pisco_total,
    }


def network_dependency_sweep():
    """Remark 4: p = Theta(sqrt(lam_w)) improves the dependency lam_w^-2 -> lam_w^-1."""
    rows = []
    for lam_w in (1e-1, 1e-2, 1e-3, 1e-4):
        for p in (0.0, lam_w, np.sqrt(lam_w), 1.0):
            lam_p = lam_w + p * (1 - lam_w)
            rows.append({
                "lambda_w": lam_w,
                "p": float(p),
                "lambda_p": float(lam_p),
                "network_term": float(1.0 / lam_p**2),
            })
    return rows


def run(quick: bool = False, out_dir=None) -> dict:
    consts = dict(n=10, t_o=10, sigma=1.0, eps=0.05)
    table = {}
    for lam_w, p in ((0.24, 0.1), (0.01, 0.1), (0.01, 0.0), (0.24, 1.0)):
        table[f"lam_w={lam_w},p={p}"] = {
            k: (float(v) if np.isfinite(v) else None)
            for k, v in bounds(lam_w=lam_w, p=p, **consts).items()
        }
    payload = {
        "bench": "table2_complexity",
        "constants": consts,
        "table": table,
        "network_dependency": network_dependency_sweep(),
    }
    save_result("table2_complexity", payload, out_dir, device=None)
    return payload


def main():
    payload = run()
    for key, row in payload["table"].items():
        print(f"--- {key}")
        for alg, v in row.items():
            print(f"   {alg:>22}: {v:.3e}" if v is not None else f"   {alg:>22}: inf")
    print("--- network dependency (Remark 4)")
    for r in payload["network_dependency"]:
        print(f"   lam_w={r['lambda_w']:.0e} p={r['p']:.3g} -> lam_p={r['lambda_p']:.3g} "
              f"1/lam_p^2={r['network_term']:.3e}")


if __name__ == "__main__":
    main()
