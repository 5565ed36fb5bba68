"""Profiling hooks: device traces and the cost of one call.

Counterpart of ``tpu_pathtracer/utils/profiling.py``:

  - ``trace(logdir)``: a ``torch.profiler`` trace (CPU and, where there is a
    card, CUDA activity) of everything run inside the scope, written as a
    Chrome trace into ``logdir`` (open it in Perfetto or chrome://tracing);
  - ``cost_report(fn, *args)``: runs ``fn`` once and reports the floating
    point operations PyTorch's own operators did (``FlopCounterMode``) and,
    on the card, the peak bytes the call allocated.

The port's CUDA kernels are launched through ctypes, outside PyTorch's
dispatcher: the flop counter does not see them, so ``flops`` counts only
the PyTorch operators around them (and the plain versions on the CPU). Their
work is counted by ``chip_smoke.py``'s bounds instead. The report has no key
for what it cannot measure (no bytes moved, no kernel operations).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from tpu_pathtracer_torch.ops.kernels._build import build_dir
from tpu_pathtracer_torch.utils.metrics import sync_card


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Trace everything run inside the scope; yields ``logdir`` (by default
    ``build/tpu_pathtracer_torch/trace``), where the Chrome trace
    ``trace_<pid>_<ns>.json`` is written when the scope ends."""
    logdir = str(logdir or build_dir() / "trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield logdir
        finally:
            sync_card()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def cost_report(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once; returns ``{"flops": ...}``, the
    operations of PyTorch's operators in the call, and on the card also
    ``"peak_bytes"``, ``torch.cuda.max_memory_allocated()`` over the call
    (the peak statistics reset before it)."""
    on_card = torch.cuda.is_available()
    if on_card:
        sync_card()
        torch.cuda.reset_peak_memory_stats()
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    out: dict[str, Any] = {"flops": int(counter.get_total_flops())}
    if on_card:
        sync_card()
        out["peak_bytes"] = int(torch.cuda.max_memory_allocated())
    return out
