"""Profiler hooks: a ``torch.profiler`` capture and kernel-build seconds (the
twin of ``repro.obs.profile``).

* :func:`profile_capture` — context manager around ``torch.profiler.profile``
  with CUDA activity (the device's kernels, copies and the runtime calls
  that launched them; CPU activity where there is no card), which on exit
  writes the Chrome trace to ``<outdir>/trace.json`` (``ui.perfetto.dev``
  opens it).  Host operators are left out on a card: a benchmark's every
  PyTorch call would make the trace hundreds of MB.  ``outdir=None`` (the
  default everywhere) is a strict no-op.

* :func:`track_compile_time` — the port has no jit, so nothing is compiled
  while a program runs but the hand-written kernels: the first launch of a
  kernel builds every ``csrc/*.cu`` with ``nvcc`` (or finds the build on
  disk) and loads the library (:func:`repro_torch.kernels.build.library`).
  :attr:`CompileStats.seconds` is the seconds spent building and loading
  kernel libraries inside the ``with`` block; :attr:`CompileStats.events`
  keys them by source name (``"flash_attention"``, ...).  A load that
  builds all sources is charged to the source whose launch asked for it.
  Nested blocks attribute each load to the innermost.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterator, Optional


@dataclasses.dataclass
class CompileStats:
    """Kernel-library build and load seconds observed while a
    ``track_compile_time`` block ran."""

    seconds: float = 0.0
    events: Dict[str, float] = dataclasses.field(default_factory=dict)

    def _observe(self, source: str, duration_s: float) -> None:
        self.events[source] = self.events.get(source, 0.0) + duration_s
        self.seconds += duration_s


@contextlib.contextmanager
def track_compile_time() -> Iterator[CompileStats]:
    """Yield a :class:`CompileStats` accumulating the kernel-library build
    and load seconds spent inside the block."""
    from repro_torch.kernels import build  # lazy: the gate imports this package bare

    stats = CompileStats()
    build.LOAD_LISTENERS.append(stats._observe)
    try:
        yield stats
    finally:
        build.LOAD_LISTENERS.remove(stats._observe)


@contextlib.contextmanager
def profile_capture(outdir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into
    ``<outdir>/trace.json``.  ``outdir=None`` is a no-op, so call sites need
    no conditional.  CUDA activity with a card, CPU activity without."""
    if not outdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]) as prof:
        yield
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
