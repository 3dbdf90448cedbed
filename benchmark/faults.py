"""Faults planted under the timed path, to show that the check refuses
them. Each is a context manager that patches the port for its duration:

- ``altered``: one served slice of every batch comes out mirrored, an
  answer altered where it is produced;
- ``half_batch``: serving answers the second half of every batch with
  zeros; training computes its loss and gradients over the first half of
  every batch, the mean taken over the rest;
- ``half_batch_strided``: the same with every second slice of the batch
  left out in place of its second half;
- ``unchanged``: the training step returns its state unchanged (the
  optimizer takes no step).

One chip runs each cell, so the fault of a missing exchange between
chips has no place here.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _serving(edit):
    from mri_superresolution_torch.infer.engine import InferenceEngine

    def make(orig):
        def dispatch(self, batch, *a, **k):
            with torch.inference_mode():
                return [edit(y) for y in orig(self, batch, *a, **k)]
        return dispatch
    return _patched(InferenceEngine, "_dispatch_once", make)


def _mirror_first(y):
    y = y.clone()
    y[0] = y[0].flip(-1)
    return y


# the rows that half a batch keeps: its first half, or every second row
HALVES = {"half_batch": lambda n: slice(0, n // 2),
          "half_batch_strided": lambda n: slice(0, n, 2)}


def _zero_left_out(name):
    def edit(y):
        y = y.clone()
        kept = torch.zeros(y.shape[0], dtype=torch.bool, device=y.device)
        kept[HALVES[name](y.shape[0])] = True
        y[~kept] = 0
        return y
    return edit


@contextlib.contextmanager
def _train_half_batch(name):
    from mri_superresolution_torch.train import trainer

    def make(orig):
        def loss_and_grads(model, loss_fn, hr, lo, w, *a, **k):
            keep = HALVES[name](hr.shape[0])
            return orig(model, loss_fn, hr[keep], lo[keep], w[keep], *a, **k)
        return loss_and_grads
    with _patched(trainer, "loss_and_grads", make):
        yield


@contextlib.contextmanager
def _unchanged():
    from mri_superresolution_torch.train import trainer

    def make(orig):
        def make_optimizer(*a, **k):
            opt = orig(*a, **k)
            opt.step = lambda *_, **__: None
            return opt
        return make_optimizer
    with _patched(trainer, "make_optimizer", make):
        yield


def planted(name: str, kind: str):
    """The fault ``name`` for a cell whose mix is of ``kind``."""
    if kind == "train":
        return _unchanged() if name == "unchanged" else \
            _train_half_batch(name)
    return _serving(_mirror_first if name == "altered"
                    else _zero_left_out(name))


FAULTS = {"volume": ("altered", "half_batch", "half_batch_strided"),
          "train": ("half_batch", "half_batch_strided", "unchanged")}
