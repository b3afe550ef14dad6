"""Operation counts of one step and its roofline terms (the twin of
``repro.utils.hlo``).

The reference reads its counts off a compiled XLA module: FLOPs and bytes
accessed from ``cost_analysis()``, memory from ``memory_analysis()``,
collective bytes by parsing the HLO text.  PyTorch runs eagerly and has no
module to parse, so :func:`count_call` runs the step itself, on meta tensors
(nothing is allocated), under two dispatch modes:

* ``torch.utils.flop_counter.FlopCounterMode``: the matmul, convolution and
  attention FLOPs (elementwise operations count no FLOPs here; their traffic
  is in the bytes);
* :class:`OpCounter`: each operation's input and output bytes summed (views
  move nothing and count nothing) — the unfused count, as XLA's ``bytes
  accessed`` is before fusion — the elements of transcendental operations,
  and the peak of live bytes over the call, arguments included.

Collective bytes come from the mesh the step runs over
(:class:`repro_torch.launch.mesh.CountingMesh`).  The HLO parsing of the
reference (``collective_bytes``, ``shape_bytes``) has no counterpart.

:class:`Roofline` turns the counts into per-device seconds at an H100's peaks
(SXM spec sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4 at
450 GB/s a direction), keyword arguments of :meth:`Roofline.from_counts`.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM 80GB, spec sheet
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # NVLink 4, bytes/s a direction

# operations that only relabel a tensor's storage: no bytes move
_VIEWS = {
    "view", "_unsafe_view", "reshape", "expand", "transpose", "t", "permute", "slice",
    "select", "unsqueeze", "squeeze", "detach", "alias", "as_strided", "unbind", "split",
    "split_with_sizes", "chunk", "narrow", "view_as_real", "view_as_complex", "diagonal",
    "unfold", "lift_fresh", "_reshape_alias", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided",
}
# operations with one transcendental per output element (XLA's exp, log,
# logistic, tanh, rsqrt, sqrt, sin, cos, erf, power; softmax's exp)
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid", "rsqrt",
    "sqrt", "sin", "cos", "erf", "pow", "silu", "gelu", "softplus", "_softmax",
    "_log_softmax", "logsumexp", "silu_backward", "gelu_backward",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Bytes accessed, transcendental elements and live bytes of every
    operation dispatched while active.  Live bytes follow storages: one is
    counted when an operation first returns it and released when it is
    freed (views share their base's)."""

    def __init__(self, held=()):
        super().__init__()
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.live = 0
        self.peak = 0
        # storages that live before the call (the arguments) count as held:
        # an operation that writes one in place allocates nothing
        self._storages: Dict[int, int] = dict.fromkeys(held, 0)

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        outs = _tensors(out)
        if name not in _VIEWS:
            self.bytes_accessed += sum(map(_nbytes, _tensors((args, kwargs)) + outs))
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        for t in outs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key not in self._storages:
                self._storages[key] = storage.nbytes()
                self.live += storage.nbytes()
                weakref.finalize(storage, self._release, key)
        self.peak = max(self.peak, self.live)
        return out


def _tree_nbytes(tree) -> int:
    """Bytes of the tensors in a tree, each storage once."""
    seen = {}
    for t in _tensors(tree):
        seen[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
    return sum(seen.values())


def count_call(fn: Callable, args: tuple, mesh) -> Dict[str, Any]:
    """Run ``fn(*args)`` (meta tensors) under the counters: the
    reference's ``memory`` and ``cost`` records, ``mesh``'s collective
    counts (a :class:`repro_torch.launch.mesh.CountingMesh`), and
    ``trace_s``, the seconds the call took on the host.

    ``peak_bytes`` is the arguments plus the most bytes allocated beside
    them at once; ``alias_bytes`` the output bytes that share the
    arguments' storage (caches updated in place); ``temp_bytes`` what the
    peak holds beyond the arguments and the outputs."""
    mesh.reset_counts()
    arg_keys = {t.untyped_storage()._cdata for t in _tensors(args)}
    argument_bytes = _tree_nbytes(args)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, OpCounter(arg_keys) as ops:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    outs = _tensors(out)
    output_bytes = _tree_nbytes(out)
    alias_bytes = _tree_nbytes([t for t in outs if t.untyped_storage()._cdata in arg_keys])
    peak = argument_bytes + ops.peak
    return {
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": max(0, peak - argument_bytes - output_bytes + alias_bytes),
            "peak_bytes": peak,
            "alias_bytes": alias_bytes,
        },
        "cost": {
            "flops": float(flops.get_total_flops()),
            "bytes_accessed": float(ops.bytes_accessed),
            "transcendentals": float(ops.transcendentals),
        },
        "flops_int": int(flops.get_total_flops()),
        "collectives": mesh.collective_counts(),
        "trace_s": trace_s,
    }


@dataclasses.dataclass
class Roofline:
    """All quantities per device per step; terms in seconds."""

    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: Optional[float] = None  # 6·N·D (active N for MoE), whole step
    useful_ratio: Optional[float] = None  # model_flops / (flops_per_device · chips)

    @classmethod
    def from_counts(
        cls,
        flops_per_device: float,
        hbm_bytes: float,
        coll_bytes: float,
        *,
        model_flops: Optional[float] = None,
        n_chips: int = 1,
        peak_flops: float = PEAK_FLOPS_BF16,
        hbm_bw: float = HBM_BW,
        link_bw: float = LINK_BW,
    ) -> "Roofline":
        compute_s = flops_per_device / peak_flops
        memory_s = hbm_bytes / hbm_bw
        collective_s = coll_bytes / link_bw
        terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
        dominant = max(terms, key=terms.get)
        ratio = None
        if model_flops is not None and flops_per_device > 0:
            ratio = model_flops / (flops_per_device * n_chips)
        return cls(
            flops_per_device=flops_per_device,
            hbm_bytes_per_device=hbm_bytes,
            collective_bytes_per_device=coll_bytes,
            compute_s=compute_s,
            memory_s=memory_s,
            collective_s=collective_s,
            dominant=dominant,
            model_flops=model_flops,
            useful_ratio=ratio,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
