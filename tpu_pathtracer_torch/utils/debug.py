"""Numerical debugging: NaN and Inf checks on every PyTorch operator.

Counterpart of ``tpu_pathtracer/utils/debug.py`` (``jax_debug_nans`` and
``checkify``). The integrator divides and takes square roots often, so the
poison worth catching is a NaN or an Inf:

  with debug_mode():                # raise at the first non-finite op
      render(...)

  checked = checkify_render(render)  # or record it and go on
  err, img = checked(...)
  err.throw()

Both watch the outputs of PyTorch's operators (aten ops) through a
``TorchDispatchMode``. The CUDA kernels are launched through ctypes, outside
the dispatcher, so a kernel's output is seen only when a later operator
reads it, and the error then names that operator. Each check reads the
output back, a device sync per operator, so neither is ever on unless asked
for. Out-of-range indices need no switch: PyTorch raises on them on the CPU
and asserts on the card.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _NonFinite(TorchDispatchMode):
    """Checks every float output of every aten op; raises at the first NaN
    or Inf, or (``record``) keeps the first message and goes on."""

    def __init__(self, nans: bool, infs: bool, record: bool = False):
        super().__init__()
        self.nans, self.infs, self.record = nans, infs, record
        self.first: str | None = None

    def check(self, where, out) -> None:
        for t in tree_leaves(out):
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                continue
            what = None
            if self.nans and bool(torch.isnan(t).any()):
                what = "NaN"
            elif self.infs and bool(torch.isinf(t).any()):
                what = "Inf"
            if what is None:
                continue
            msg = f"{where} produced a {what}"
            if not self.record:
                raise FloatingPointError(msg)
            if self.first is None:
                self.first = msg

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.check(f"aten op {func}", out)
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """Within the scope, raise FloatingPointError naming the first aten op
    whose float output holds a NaN (``nans``) or an Inf (``infs``), and run
    autograd with anomaly detection (a backward op's NaN names the forward
    op that made it)."""
    with torch.autograd.set_detect_anomaly(True, check_nan=nans), \
            _NonFinite(nans, infs):
        yield


class RenderError:
    """What ``checkify_render``'s call met: ``get()`` is the first message
    or None, ``throw()`` raises FloatingPointError with it."""

    def __init__(self, message: str | None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def checkify_render(fn: Callable, nans: bool = True, infs: bool = True
                    ) -> Callable:
    """Wrap a render or step function: the wrapper returns ``(error,
    output)``, where ``error.throw()`` raises if an aten op of the call, or
    the call's own output, held a NaN or an Inf."""

    @functools.wraps(fn)
    def checked(*args, **kwargs):
        mode = _NonFinite(nans, infs, record=True)
        with mode:
            out = fn(*args, **kwargs)
        mode.check("the output", out)
        return RenderError(mode.first), out

    return checked
