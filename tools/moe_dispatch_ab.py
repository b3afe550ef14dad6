#!/usr/bin/env python3
"""The MoE layer's expert dispatch in three forms, on one card, at the
published widths of Mixtral-8x7B and DeepSeek-V2-Lite (bf16 experts, the f32
router, weights drawn from a seed):

- ``batched``: ``repro_torch.models.moe.dispatch_batched``, the reference's
  (E, cap, d) buffer and one batched product over the experts, no host sync
  (the port's form for a routing group of more than one token);
- ``loop``: the expert counts copied to the host, then each expert with
  kept entries runs its FFN on those rows alone, its weights read in place
  (the form written here for comparison only);
- ``in_place``: ``dispatch_in_place``, one token's k experts read in place
  (the port's form for a decode step; T = 1 only).

Each shape is a prefill (Mixtral's served 4,608-token prompt, DeepSeek's
500) and a decode step (T = 1).  For each form: wall ms a call (CUDA events
around 10 calls, host syncs included), device ms (``torch.profiler``), the
device's idle share, the whole ``moe_forward`` layer, and max |err| against
the batched form.  Run from the repo's root on a card:

    python3 tools/moe_dispatch_ab.py
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import device_ms, max_err, time_ms  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

SHAPES = (("mixtral-8x7b", 4608), ("mixtral-8x7b", 1),
          ("deepseek-v2-lite-16b", 500), ("deepseek-v2-lite-16b", 1))


def dispatch_loop(experts, cfg, xf, top_idx, top_w):
    """Each expert with kept entries on its rows alone; the counts on the host."""
    mo = cfg.moe
    t, d = xf.shape
    k, cap = mo.top_k, M.capacity(mo, t)
    flat = top_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=mo.n_experts).tolist()
    pos, vals, start = [], [], 0
    for e, n in enumerate(counts):
        kept = min(n, cap)
        if kept:
            src = order[start:start + kept]
            y_e = M._ffn({name: w[e] for name, w in experts.items()}, cfg.mlp_type, xf[src // k])
            pos.append(src)
            vals.append(y_e * top_w.reshape(-1)[src].to(y_e.dtype)[:, None])
        start += n
    contrib = torch.zeros((t * k, d), dtype=xf.dtype, device=xf.device)
    return contrib.index_copy(0, torch.cat(pos), torch.cat(vals)).reshape(t, k, d)


def main() -> int:
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for arch, t in SHAPES:
        cfg = get_config(arch)
        params = M.init_moe(gen, cfg, torch.bfloat16)
        experts = {n: params[n] for n in ("w_gate", "w_up", "w_down") if n in params}
        xf = torch.randn(t, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
        top_idx, top_w, _ = M.route(xf.float() @ params["router"], cfg.moe)
        forms = {"batched": M.dispatch_batched, "loop": dispatch_loop}
        if t == 1:
            forms["in_place"] = M.dispatch_in_place
        want = M.dispatch_batched(experts, cfg, xf, top_idx, top_w)
        for name, fn in forms.items():
            call = lambda: fn(experts, cfg, xf, top_idx, top_w)  # noqa: E731
            wall, dev_ms = time_ms(torch, call), device_ms(torch, call, iters=10)
            print(json.dumps(dict(
                arch=arch, tokens=t, experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                capacity=M.capacity(cfg.moe, t), form=name, ms=wall, device_ms=dev_ms,
                idle=max(0.0, 1.0 - dev_ms / wall),
                max_abs_err=max_err(call(), want) / (1.0 + float(want.float().abs().max())))),
                flush=True)
        layer = lambda: M.moe_forward(params, cfg, xf[None])  # noqa: E731
        wall, dev_ms = time_ms(torch, layer), device_ms(torch, layer, iters=10)
        print(json.dumps(dict(arch=arch, tokens=t, form="moe_forward", ms=wall,
                              device_ms=dev_ms, idle=max(0.0, 1.0 - dev_ms / wall))), flush=True)
        del params, experts
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
