"""Whether bf16 training on the GPU repeats bit for bit, and what moves it.

    python -m mri_superresolution_torch.tools.repeat_train [--steps 6]
        [--batch 8 --size 128 --base_filters 32] [--pairs 120 --epochs 20]
        [--workdir DIR] [--cpu]

The unet (bf16 compute on fp32 master weights, L1 + SSIM, Adam at the
trainer's defaults), in three ways, each in two modes: ``port``, the
trainer without its ``repeatable`` scope, and ``repeatable``, as the
trainer runs (cuDNN restricted to deterministic algorithms, its
benchmark off). One JSON line each:

- the train CLI on ``pairs`` phantom pairs of ``size``^2 -> (2 size)^2
  (every 15th black, as extraction writes past the anatomy) for
  ``epochs``, twice in this process with unrelated card work between
  them (a bf16 serving forward at 16 x 256^2 and a convolution forward
  and backward at another shape) and once in a fresh process: whether
  the final checkpoints are the same bytes;
- ``steps`` steps on one phantom batch in fresh processes, each after
  another state of the caching allocator (fresh, one 8 GiB block freed,
  fragments freed; and in ``repeatable`` the cache emptied first): the
  digest of every parameter and Adam moment;
- the same steps twice in this process with the unrelated work between,
  compared after every step (the first step and tensor that differ),
  and a third mode with the port's kernels swapped for their plain
  versions (``tools/grad_gap.use_plain_kernels``).

Then one step under ``torch.use_deterministic_algorithms(True,
warn_only=True)``, whose warnings name every operation PyTorch knows to be
nondeterministic on this device, and the step's time (CUDA events, 10
steps after 2 warm-up) without and with the scope in turns (port,
repeatable, repeatable, port). ``--cpu`` runs the comparisons on the CPU
at whatever size is given (a rehearsal: no time is printed).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from mri_superresolution_torch.config import LossConfig, ModelConfig
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.tools.grad_gap import use_plain_kernels
from mri_superresolution_torch.train import trainer
from mri_superresolution_torch.utils.phantom import phantom_batch


def _batch(n: int, size: int, dev) -> dict:
    return {"lr": torch.from_numpy(phantom_batch(
                np.random.default_rng(2), n, size)[..., None]).to(dev),
            "hr": torch.from_numpy(phantom_batch(
                np.random.default_rng(2), n, 2 * size)[..., None]).to(dev),
            "weight": torch.ones(n, device=dev)}


def _trainer(cfg: ModelConfig, dev):
    model = build_model(cfg, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0)).to(dev)
    opt = trainer.make_optimizer(model.parameters(), 1e-4, 1e-5)
    loss_fn = CombinedLoss(LossConfig())

    def step(batch):
        """The trainer's step without augmentation, EMA or QAT, and
        without its ``repeatable`` scope (the caller sets the flags)."""
        _, _, grads = trainer.loss_and_grads(
            model, loss_fn, batch["hr"], batch["lr"], batch["weight"])
        for p, g in zip(model.parameters(), grads):
            p.grad = g
        opt.step()

    return model, opt, step


def _snapshot(model, opt) -> list:
    out = []
    for name, p in model.named_parameters():
        st = opt.state.get(p, {})
        out.append((name, p.detach().clone()))
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                out.append((f"{name}.{k}", st[k].detach().clone()))
    return out


def _run(cfg, dev, batch, steps: int) -> list:
    model, opt, step = _trainer(cfg, dev)
    snaps = []
    for _ in range(steps):
        step(batch)
        snaps.append(_snapshot(model, opt))
    return snaps


def _other_work(cfg, dev) -> None:
    """Card work unrelated to the runs: a bf16 serving forward at 16 x
    256^2, and a convolution at another shape, forward and backward."""
    m = build_model(cfg, dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(5)).to(dev).eval()
    with torch.inference_mode():
        m(torch.rand((16, 256, 256, 1), generator=torch.Generator(
            ).manual_seed(5)).to(dev))
    x = torch.randn((4, 24, 72, 40), generator=torch.Generator().manual_seed(
        6)).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    w = torch.randn((40, 24, 3, 3), generator=torch.Generator().manual_seed(
        7)).to(dev, torch.bfloat16).requires_grad_()
    F.conv2d(x, w, padding=1).float().square().sum().backward()
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _compare(a: list, b: list) -> dict:
    first = None
    for i, (sa, sb) in enumerate(zip(a, b)):
        for (name, ta), (_, tb) in zip(sa, sb):
            if not torch.equal(ta, tb):
                first = {"step": i + 1, "tensor": name}
                break
        if first:
            break
    last = max(float((ta.float() - tb.float()).abs().max())
               for (_, ta), (_, tb) in zip(a[-1], b[-1]))
    return {"first_difference": first, "max_abs_after_last_step": last,
            "bit_equal": first is None}


def _nondeterministic_ops(step, batch) -> list:
    """The warnings one step raises under
    ``use_deterministic_algorithms(True, warn_only=True)``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step(batch)
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).splitlines()[0][:300] for w in caught})


def _step_ms(step, batch, ctx, iters: int = 10, warmup: int = 2) -> float:
    with ctx():
        for _ in range(warmup):
            step(batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            step(batch)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / iters


# the caching allocator's state a child process leaves before it trains
PRE_STATES = ("fresh", "one 8 GiB block freed", "fragments freed")
FLAGS = ("port", "repeatable", "repeatable, cache emptied")


def _pre_state(name: str, dev) -> list:
    """Leave the allocator as ``name`` says; returns what stays alive."""
    keep = []
    if dev.type != "cuda":
        return keep
    if name == "one 8 GiB block freed":
        torch.empty(8 << 30, dtype=torch.uint8, device=dev)
    elif name == "fragments freed":
        blocks = [torch.empty(n << 20, dtype=torch.uint8, device=dev)
                  for n in (3, 40, 7, 300, 24, 96, 5, 650, 12, 180)]
        keep = blocks[::2]
    return keep


def _child(args, dev) -> int:
    """One training run in this process after ``--pre_state``, in the
    mode ``--flags``: prints the SHA-256 of every parameter and moment."""
    import hashlib
    keep = _pre_state(args.pre_state, dev)
    ctx = {"port": contextlib.nullcontext,
           "repeatable": trainer.repeatable,
           "repeatable, cache emptied": trainer.repeatable}[args.flags]
    if args.flags == "repeatable, cache emptied" and dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg = ModelConfig(base_filters=args.base_filters)
    with ctx():
        snaps = _run(cfg, dev, _batch(args.batch, args.size, dev),
                     args.steps)
    h = hashlib.sha256()
    for _, t in snaps[-1]:
        h.update(t.float().cpu().numpy().tobytes())
    print(json.dumps({"sha256": h.hexdigest(), "kept": len(keep)}))
    return 0


def _processes(args) -> None:
    """Each flag mode in a fresh process a pre-state: whether the bits
    depend on what the process allocated before it trained."""
    import subprocess
    for flags in FLAGS:
        digests = {}
        for pre in PRE_STATES:
            r = subprocess.run(
                [sys.executable, "-m", "mri_superresolution_torch.tools."
                 "repeat_train", "--child", "--pre_state", pre, "--flags",
                 flags, "--steps", str(args.steps), "--batch",
                 str(args.batch), "--size", str(args.size),
                 "--base_filters", str(args.base_filters)]
                + (["--cpu"] if args.cpu else []),
                capture_output=True, text=True, timeout=600)
            if r.returncode:
                raise RuntimeError(r.stderr[-3000:])
            digests[pre] = json.loads(r.stdout.strip().splitlines()[-1]
                                      )["sha256"][:16]
        print(json.dumps({"processes": flags, "digests": digests,
                          "bit_equal": len(set(digests.values())) == 1}),
              flush=True)


def _write_pairs(root, n: int, size: int) -> None:
    """``n`` phantom pairs of ``size``^2 -> (2 size)^2 as PNGs under
    root/hr and root/lr; every 15th pair black (LR and HR all zero), as
    extraction writes a slice past the anatomy."""
    from mri_superresolution_torch import native
    hr = phantom_batch(np.random.default_rng(1), n, 2 * size)
    lr = phantom_batch(np.random.default_rng(1), n, size)
    hr[::15], lr[::15] = 0.0, 0.0
    for sub, imgs in (("hr", hr), ("lr", lr)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i, img in enumerate(imgs):
            native.imwrite_gray(
                os.path.join(root, sub, f"sub-{i // 10:02d}_T1w_s{i:03d}.png"),
                np.round(img * 255).astype(np.uint8))


def _train_cli(args, root, out, flags: str) -> None:
    """The train CLI at the JAX package's defaults on the pairs under
    ``root``, writing to ``out``; with ``flags`` "port" the trainer's
    ``repeatable`` scope is taken away."""
    from mri_superresolution_torch.cli import train as train_cli
    saved = trainer.repeatable
    if flags == "port":
        trainer.repeatable = contextlib.nullcontext
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main([
                "--full_res_dir", os.path.join(root, "hr"),
                "--low_res_dir", os.path.join(root, "lr"),
                "--base_filters", str(args.base_filters),
                "--batch_size", str(args.batch),
                "--epochs", str(args.epochs), "--seed", "1",
                "--checkpoint_dir", out, "--log_dir",
                os.path.join(out, "logs")]
                + (["--cpu"] if args.cpu else []))
    finally:
        trainer.repeatable = saved


def _ckpt_bytes(out) -> bytes:
    with open(os.path.join(out, "final_model_unet.ckpt"), "rb") as f:
        return f.read()


def _cli_runs(args, dev) -> None:
    """The train CLI twice in this process, with other card work between,
    and once in a fresh process, for each flag mode: whether the final
    checkpoints are the same bytes."""
    import hashlib
    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory(dir=args.workdir) as tmp:
        _write_pairs(tmp, args.pairs, args.size)
        for flags in ("port", "repeatable"):
            outs = [os.path.join(tmp, f"{flags}_{i}") for i in range(3)]
            _train_cli(args, tmp, outs[0], flags)
            _other_work(ModelConfig(base_filters=args.base_filters), dev)
            _train_cli(args, tmp, outs[1], flags)
            r = subprocess.run(
                [sys.executable, "-m", "mri_superresolution_torch.tools."
                 "repeat_train", "--child_cli", tmp, outs[2], "--flags",
                 flags, "--epochs", str(args.epochs), "--batch",
                 str(args.batch), "--base_filters", str(args.base_filters)]
                + (["--cpu"] if args.cpu else []),
                capture_output=True, text=True, timeout=1200)
            if r.returncode:
                raise RuntimeError(r.stderr[-3000:])
            digests = [hashlib.sha256(_ckpt_bytes(o)).hexdigest()[:16]
                       for o in outs]
            print(json.dumps({
                "train_cli": flags, "pairs": args.pairs,
                "epochs": args.epochs,
                "digests": dict(zip(("first", "second, same process",
                                     "fresh process"), digests)),
                "bit_equal": len(set(digests)) == 1}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--base_filters", type=int, default=32)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--pre_state", default="fresh", choices=PRE_STATES)
    ap.add_argument("--flags", default="port", choices=FLAGS)
    ap.add_argument("--pairs", type=int, default=120)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--workdir", default=None,
                    help="where the train CLI's pairs and checkpoints go "
                         "(a temporary directory in it)")
    ap.add_argument("--child_cli", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("repeat_train: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.cpu else "cuda")
    if args.child:
        return _child(args, dev)
    if args.child_cli:
        _train_cli(args, *args.child_cli, args.flags)
        return 0
    device = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    cfg = ModelConfig(base_filters=args.base_filters)
    batch = _batch(args.batch, args.size, dev)
    _cli_runs(args, dev)
    _processes(args)
    modes = (("port", contextlib.nullcontext, False),
             ("repeatable", trainer.repeatable, False),
             ("plain kernels", contextlib.nullcontext, True))
    for label, ctx, plain in modes:
        use_plain_kernels(plain)
        try:
            with ctx():
                a = _run(cfg, dev, batch, args.steps)
                _other_work(cfg, dev)
                b = _run(cfg, dev, batch, args.steps)
        finally:
            use_plain_kernels(False)
        print(json.dumps({"mode": label, "steps": args.steps,
                          "batch": args.batch, "size": args.size,
                          **_compare(a, b), "device": device}), flush=True)
    _, _, step = _trainer(cfg, dev)
    print(json.dumps({"mode": "use_deterministic_algorithms",
                      "warnings": _nondeterministic_ops(step, batch),
                      "device": device}), flush=True)
    if args.cpu:
        return 0
    times = {"port": [], "repeatable": []}
    for label in ("port", "repeatable", "repeatable", "port"):
        ctx = trainer.repeatable if label == "repeatable" else \
            contextlib.nullcontext
        times[label].append(_step_ms(step, batch, ctx))
    print(json.dumps({"step_ms": times, "batch": args.batch,
                      "size": args.size, "dtype": "bfloat16",
                      "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
