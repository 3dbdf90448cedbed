"""Multi-process data-parallel training over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/multihost.py``. There,
``jax.distributed`` joins one process a host into one global device list
and GSPMD places the batch and reduces the gradients. Here every rank is a
process of its own on one device (``cuda:i``, or the CPU), the ranks form
one process group, and the trainer reduces explicitly:

- :func:`initialize`: joins this process to the job by TCP rendezvous
  (``tcp://<coordinator>``), NCCL on a card and gloo on the CPU; a CUDA
  group runs gloo only when ``backend="gloo"`` is passed, nothing
  switches backend by itself, and a failed NCCL init raises. Without a
  coordinator it reads the variables ``torchrun`` sets (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), the
  counterpart of JAX's automatic cluster detection;
- :func:`active`, :func:`is_main`, :func:`rank`, :func:`world`;
- :func:`agree`: rank 0's value on every rank (a broadcast);
- :class:`Collectives`: the sums, maxima and gathers of the trainer and
  of the ZeRO-1 optimizer, over flat fp32 buckets in a fixed order, and
  :data:`LOCAL`, the same reductions in a process of no group (each
  returns its inputs); :func:`gather_tree` gathers ZeRO-1 slices into
  the full layout;
- :func:`launch` and :func:`main`: the local ranks that ``--num_devices``
  starts, each ``python -m mri_superresolution_torch.parallel.multihost``
  running a target of the port (``module:function``), so that a rank
  imports only the port.

Checkpoints, logs, figures and the stdout protocol are rank 0's; that
gating lives in ``train/trainer.py``.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from mri_superresolution_torch.utils.device import resolve_device
from mri_superresolution_torch.utils.subproc import child_env

_PACKAGE = "mri_superresolution_torch."
_TIMEOUT = datetime.timedelta(minutes=10)
_device: Optional[torch.device] = None


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> torch.device:
    """Join this process to the job as rank ``process_id`` of
    ``num_processes``, the group's store at ``coordinator`` (host:port,
    rank 0 listens there); returns the rank's device. ``device`` defaults
    to ``cuda:LOCAL_RANK`` under ``torchrun``, else ``cuda:0``; with no
    card visible that raises, and the ranks run on the CPU only when the
    caller passes ``device="cpu"`` (``--cpu``). ``backend`` defaults to
    NCCL for a CUDA device and gloo for the CPU."""
    global _device
    env = os.environ
    if coordinator is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                               "RANK") if k not in env]
        if missing:
            raise ValueError(
                f"--multihost without --coordinator reads torchrun's "
                f"variables, and {missing} are not set: pass --coordinator, "
                f"--num_processes and --process_id, or start under torchrun")
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
        if device is None:
            device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num_processes and "
                         "--process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in "
                         f"[0, {num_processes})")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=_TIMEOUT, **kwargs)
    _device = dev
    return dev


def active() -> bool:
    """True once this process belongs to a process group (a world of 1
    included: its collectives still run)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    """True on the rank that owns checkpoints, logs and the stdout
    protocol (rank 0), and in a process of no group."""
    return rank() == 0


def backend() -> Optional[str]:
    return dist.get_backend() if active() else None


def rank_devices() -> List[str]:
    """Every rank's device, in rank order (a collective)."""
    names: List[Optional[str]] = [None] * world()
    dist.all_gather_object(names, str(_device))
    return [str(n) for n in names]


def shutdown() -> None:
    if active():
        dist.destroy_process_group()


def _comm_device() -> torch.device:
    """Where a collective's buffer lives: the rank's card under NCCL, and
    under gloo the rank's device too (gloo reduces CUDA tensors through
    host memory itself)."""
    return _device if _device is not None else torch.device("cpu")


def agree(value):
    """Rank 0's ``value`` (a number) on every rank, by broadcast. Guards
    host-side randomness that would otherwise diverge the ranks: the
    trainer agrees on the seed, since an unseeded ``--seed`` default draws
    a different one in each process."""
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_comm_device())
    dist.broadcast(t, 0)
    out = t.item()
    return int(out) if isinstance(value, int) else out


class Collectives:
    """The collectives of one data-parallel step over the default group,
    or over the subgroup ``group`` (a ``dist.new_group``; the spatial
    trainer's data groups).

    ``sum_`` and ``max_`` reduce a list of tensors as one flat fp32 bucket
    (one collective, the tensors in the order given) and return the
    reduced tensors in their shapes and dtypes; ``gather`` returns every
    rank's copy of a tensor of one shape. ``seconds`` adds up the time
    spent in them when ``timed`` is set (each call then synchronizes the
    device)."""

    def __init__(self, dev: Optional[torch.device] = None, group=None):
        self.group = group
        self.world = world() if group is None else dist.get_world_size(group)
        self.rank = rank() if group is None else dist.get_rank(group)
        self.device = torch.device(dev) if dev is not None else \
            _comm_device()
        self.timed = False
        self.seconds = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _reduce(self, tensors: Sequence[torch.Tensor], op) -> list:
        tensors = list(tensors)
        if not tensors:
            return []
        flat = torch.cat([t.detach().reshape(-1).to(self.device,
                                                    torch.float32)
                          for t in tensors])
        if self.timed:
            self._sync()
            t0 = time.perf_counter()
        dist.all_reduce(flat, op=op, group=self.group)
        if self.timed:
            self._sync()
            self.seconds += time.perf_counter() - t0
        out, i = [], 0
        for t in tensors:
            n = t.numel()
            out.append(flat[i:i + n].reshape(t.shape).to(t.device, t.dtype))
            i += n
        return out

    def sum_(self, tensors: Sequence[torch.Tensor]) -> list:
        return self._reduce(tensors, dist.ReduceOp.SUM)

    def max_(self, tensors: Sequence[torch.Tensor]) -> list:
        return self._reduce(tensors, dist.ReduceOp.MAX)

    def gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (the same shape on each), in rank order."""
        src = t.detach().contiguous().to(self.device)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        if self.timed:
            self._sync()
            t0 = time.perf_counter()
        dist.all_gather(parts, src, group=self.group)
        if self.timed:
            self._sync()
            self.seconds += time.perf_counter() - t0
        return [p.to(t.device) for p in parts]


class _Local:
    """:class:`Collectives`' reductions in a process of no group: a world
    of one, whose sum and max of a list of tensors are the tensors
    themselves, with no copy and no collective."""

    world = 1

    def sum_(self, tensors: Sequence[torch.Tensor]) -> list:
        return list(tensors)

    max_ = sum_


LOCAL = _Local()


def gather_tree(coll: Collectives, shards: Dict[str, torch.Tensor],
                axes: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """The full tensors of ZeRO-1 slices: ``shards[k]`` is this rank's
    slice along ``axes[k]`` (rank r holds the r-th of equal parts). One
    gather of a flat bucket, the keys in the order given; every rank must
    call it at the same point."""
    keys = list(shards)
    if not keys:
        return {}
    flat = torch.cat([shards[k].detach().reshape(-1).float() for k in keys])
    parts = coll.gather(flat)
    out, i = {}, 0
    for k in keys:
        s = shards[k]
        n = s.numel()
        out[k] = torch.cat([p[i:i + n].reshape(s.shape) for p in parts],
                           dim=axes[k]).to(s.dtype)
        i += n
    return out


# ------------------------------------------------------------ local ranks

def free_port() -> int:
    """A TCP port that was free on 127.0.0.1 a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(target: str, argv: Sequence[str], devices: Sequence,
           coordinator: str, world_size: int, rank_base: int = 0,
           backend: Optional[str] = None,
           env: Optional[Dict[str, str]] = None) -> int:
    """Start one rank a device of ``devices`` (global ranks ``rank_base``,
    ``rank_base + 1``, ...), each running ``target(argv, device)`` in a
    process of its own, and wait for all. Returns 0, or the first non-zero
    exit code; once a rank has failed the others are stopped, since they
    would wait for it in their next collective."""
    if not target.startswith(_PACKAGE):
        raise ValueError(f"a rank target must be in the port, not {target}")
    procs = []
    for i, dev in enumerate(devices):
        cmd = [sys.executable, "-m", __name__, "--target", target,
               "--coordinator", coordinator, "--world", str(world_size),
               "--rank", str(rank_base + i), "--device", str(dev)]
        if backend:
            cmd += ["--backend", backend]
        procs.append(subprocess.Popen(cmd + ["--", *argv],
                                      env=env if env is not None
                                      else child_env()))
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs
                      if p.returncode not in (None, 0)]
            if failed:
                rc = failed[0]
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None and rc != 0:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    for p in procs:
        if rc == 0 and p.returncode != 0:
            rc = p.returncode
    return rc


def main(argv=None) -> int:
    """One rank: join the group, run the target, leave the group."""
    ap = argparse.ArgumentParser(description="One rank of a data-parallel "
                                 "job of the port")
    ap.add_argument("--target", required=True,
                    help="module:function of the port, called as "
                         "function(argv, device)")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    module, _, name = args.target.partition(":")
    if not module.startswith(_PACKAGE) or not name:
        raise ValueError(f"a rank target must be module:function of the "
                         f"port, not {args.target}")
    dev = initialize(args.coordinator, args.world, args.rank, args.backend,
                     args.device)
    try:
        getattr(importlib.import_module(module), name)(rest, dev)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    # run the package's module, not this __main__ copy of it: the rank's
    # state (its device) must live where the trainer imports it from
    from mri_superresolution_torch.parallel import multihost as _module
    sys.exit(_module.main())
