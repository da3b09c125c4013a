"""The one rule that picks the code a kernel op runs (``route``): while
``torch.export`` traces, the ``torch.library`` op (``kernels/ops.py``);
where a gradient is wanted, the autograd Function; otherwise the launch on a
CUDA tensor (one C call, no dispatcher in front) or the plain version on a
CPU one. Any other device raises: there is no silent plain fallback."""

from __future__ import annotations

import torch

__all__ = ["route", "on_device"]


def on_device(name: str, x: torch.Tensor, launch, plain):
    """``launch`` for a CUDA ``x``, ``plain`` for a CPU one; raises for any
    other device."""
    if x.is_cuda:
        return launch
    if x.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return plain


def route(name: str, args: tuple, function, launch, plain, op=None, plain_grad: bool = False):
    """Run kernel op ``name`` on ``args`` (x first) by the module's rule (a
    gradient: grad mode on and a tensor argument requiring one). ``op`` None:
    none in programs. ``function`` None: no gradient, so a call that wants
    one raises. ``plain_grad``: autograd differentiates the plain one."""
    if torch.compiler.is_exporting():
        if op is None:
            raise ValueError(f"{name}: no op stands for it in an exported program")
        return op(*args)
    run = on_device(name, args[0], launch, plain)
    if torch.is_grad_enabled() and not (plain_grad and run is plain) and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        if function is None:
            raise ValueError(f"{name}: has no gradient; call it where none is wanted")
        return function.apply(*args)
    return run(*args)
