"""The port's served kernels as operators of PyTorch's dispatcher.

``torch.export`` records an operator, not a Python function: a wrapper
that launches a kernel through ``ctypes`` with ``data_ptr()`` cannot be
traced, since the fake tensors export traces with hold no memory. So each
kernel that a served forward runs (B1 ``group_norm_leaky``, B1's fused
int8 route ``gn_quantize``, B3 ``conv3x3``, B4 ``leaky_quantize``, EDSR's
``bias_epilogue``) is an operator ``torch.ops.mri_sr.<name>`` with three
implementations:

- CUDA: the wrapper's kernel launch, with its route choice, alignment
  checks and launch counter;
- CPU: the plain version, its output in channels_last memory as the
  kernels write theirs, so that a program traced on one device runs on
  the other with the same layouts;
- fake: the output's shape, dtype and layout for any batch, after the
  wrapper's own argument checks.

The library is the dispatcher's low-level one (``torch.library.Library``
with an implementation per dispatch key), a few microseconds a call
against some twenty for ``torch.library.custom_op``'s Python layers. Even
so, eager serving through the operators lost 9% of its slices/s on the
card (16 x 256^2, bf16; ``tools/serve_rate.py``, PERF.md), since the
port's serving is host-bound. So a wrapper calls its operator only while
``torch.export`` (or ``torch.compile``) traces, and otherwise the
operator's implementation directly (:func:`call`): the same function, the
same launch. Defining the operators touches no CUDA. Training does not go
through them: where autograd needs a kernel's gradient the wrapper runs
its ``torch.autograd.Function`` as before.
"""

from __future__ import annotations

import torch

LIB = torch.library.Library("mri_sr", "DEF")


def register(schema: str, impl, fake):
    """Define ``mri_sr::<schema>``, ``impl`` serving CPU and CUDA tensors
    and ``fake`` shapes; returns the operator."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    for key in ("CPU", "CUDA"):
        LIB.impl(name, impl, key)
    torch.library.register_fake(f"mri_sr::{name}", fake, lib=LIB)
    return getattr(torch.ops.mri_sr, name)


def call(op, impl, *args):
    """``op(*args)`` while a tracer records operators, else ``impl(*args)``
    (the operator's own implementation) without the dispatcher."""
    if torch.compiler.is_compiling():
        return op(*args)
    return impl(*args)
