"""Train a model of the zoo on the GPU.

    python -m mri_superresolution_torch.cli.train --full_res_dir hr \
        --low_res_dir lr [--model_type TYPE] \
        [--perceptual_weight 0.1 [--vgg_weights vgg19.npz]] [--epochs 100] \
        [--batch_size 8] [--resume] ...

``TYPE`` is any family of ``models/families.py``. Takes the flags of the
JAX package's ``scripts/train.py`` (reference scripts/train.py:486-548),
with the same defaults and meanings, and writes the same checkpoints and
JSON-line protocol (``--qat``: with the int8 calibration sidecars). Runs
on the card; ``--cpu`` runs on the CPU. ``--remat`` recomputes the
model's blocks in the backward (the same update, less memory);
``--profile_dir`` writes a ``torch.profiler`` Chrome trace of one epoch.

Data parallelism, one process a rank (``parallel/multihost.py``):

- ``--num_devices N`` (N > 1, or 0 with more than one visible GPU)
  starts N local ranks, rank i on ``cuda:i`` over NCCL; with ``--cpu``
  N gloo ranks on the CPU. The launcher waits for them and exits
  non-zero if any rank does;
- ``--multihost --coordinator host:port --num_processes P --process_id
  p`` makes this process host p of a job of P; its local ranks take the
  global ranks ``p * local + i``. Without ``--coordinator`` it reads the
  variables ``torchrun`` sets and is one rank;
- ``--opt_shard`` shards Adam's moments over the ranks (ZeRO-1);
- ``--spatial_shards S`` trains row-sharded: the ranks form a (ranks / S
  data, S space) grid, each rank holds 1/S of every image's rows, and
  halos and statistic sums cross the ranks of a space group
  (``parallel/spatial.py``). S must divide the ranks; LR H must divide by
  8 S and W by 8. With ``--opt_shard`` the moments shard over the data
  groups.

With one rank and no ``--multihost`` no process group is made and the run
is the single-device one.
"""

from __future__ import annotations

import argparse
import random
import sys


def parse_args(argv=None):
    from mri_superresolution_torch.models.families import model_flags
    p = argparse.ArgumentParser(
        description="Train MRI quality enhancement model")
    p.add_argument('--full_res_dir', type=str, required=True,
                   help='Directory containing high-quality MRI slices')
    p.add_argument('--low_res_dir', type=str, required=True,
                   help='Directory containing low-quality MRI slices')
    fill = model_flags(p, base_filters=32, num_blocks=8)
    p.add_argument('--batch_size', type=int, default=8)
    p.add_argument('--epochs', type=int, default=100)
    p.add_argument('--learning_rate', type=float, default=1e-4)
    p.add_argument('--weight_decay', type=float, default=1e-5)
    p.add_argument('--ssim_weight', type=float, default=0.3)
    p.add_argument('--perceptual_weight', type=float, default=0.0)
    p.add_argument('--vgg_layer_idx', type=int, default=35)
    p.add_argument('--perceptual_loss_type', type=str, default='l1',
                   choices=['l1', 'l2', 'mse'])
    p.add_argument('--initial_alpha', type=float, default=0.0)
    p.add_argument('--validation_split', type=float, default=0.2)
    p.add_argument('--split_by_subject', action='store_true',
                   help='Split train/val at the subject level')
    p.add_argument('--patience', type=int, default=10)
    p.add_argument('--num_workers', type=int, default=0,
                   help='Accepted for reference compatibility; the '
                        'streaming loader sizes its own decode pool')
    p.add_argument('--streaming', type=str, default='auto',
                   choices=['auto', 'on', 'off'],
                   help='off = decode all pairs up front; on = per-batch '
                        'decode with prefetch; auto = stream when the '
                        'decoded dataset exceeds --streaming_threshold_mb')
    p.add_argument('--streaming_prefetch', type=int, default=2)
    p.add_argument('--streaming_threshold_mb', type=int, default=2048)
    p.add_argument('--remat', action='store_true',
                   help='Rematerialize the forward in the backward '
                        '(torch.utils.checkpoint around each block the JAX '
                        'package remats): less activation memory for one '
                        'more forward of those blocks; the same update')
    p.add_argument('--spatial_shards', type=int, default=1,
                   help='Row-shard every image over this many ranks (it '
                        'must divide the ranks; LR H %% (8 x this) == 0, '
                        'W %% 8 == 0): activations and their tape 1/S a '
                        'rank, halos and sums between the ranks')
    p.add_argument('--grad_accum', type=int, default=1,
                   help='Split each batch into this many sequential '
                        'microbatches, accumulating fp32 gradients: the '
                        'exact full-batch update')
    p.add_argument('--opt_shard', action='store_true',
                   help='ZeRO-1: shard Adam\'s moments over the '
                        'data-parallel ranks (the same update)')
    p.add_argument('--ema_decay', type=float, default=0.0,
                   help='Polyak average of the weights after each step; '
                        'validation, best-model selection and the '
                        'checkpointed params use it. 0 = off')
    p.add_argument('--qat', action='store_true',
                   help='Quantization-aware training for int8 serving: '
                        'the int8 arithmetic simulated in float with '
                        'straight-through gradients; validation scores it, '
                        'and every checkpoint gets a <base>.calib.json of '
                        'frozen scales that --quant int8 serves')
    p.add_argument('--qat_decay', type=float, default=0.98,
                   help='EMA decay of the running activation ranges')
    p.add_argument('--save_every_steps', type=int, default=0,
                   help='Every N optimizer steps write '
                        'step_model_<type>.ckpt with the batch cursor; '
                        '--resume restarts inside the epoch '
                        'bit-identically. 0 = off')
    p.add_argument('--multihost', action='store_true',
                   help='Multi-host data-parallel training: this process '
                        'is host --process_id of --num_processes, the '
                        'process group\'s store at --coordinator (host 0 '
                        'listens there); its --num_devices local ranks '
                        'join it. Without --coordinator, torchrun\'s '
                        'variables (one rank a process). Rank 0 owns '
                        'checkpoints, logs and the stdout protocol')
    p.add_argument('--coordinator', type=str, default=None,
                   help='host:port of host 0 (multihost)')
    p.add_argument('--num_processes', type=int, default=None,
                   help='number of host processes (multihost)')
    p.add_argument('--process_id', type=int, default=None,
                   help='this host process\'s index (multihost)')
    p.add_argument('--seed', type=int, default=random.randint(1, 10000))
    p.add_argument('--augmentation', action='store_true')
    p.add_argument('--use_tensorboard', action='store_true')
    p.add_argument('--use_amp', action='store_true',
                   help='Reference-compat alias: bf16 is the default')
    p.add_argument('--no_bf16', action='store_true',
                   help='Disable bfloat16 compute (fp32 everywhere)')
    p.add_argument('--cpu', action='store_true',
                   help='Run on the CPU instead of the GPU')
    p.add_argument('--num_devices', type=int, default=0,
                   help='Local data-parallel ranks, one a GPU (0 = every '
                        'visible GPU); with --cpu, ranks on the CPU (0 = 1)')
    p.add_argument('--resume', action='store_true',
                   help='Resume from the final or step checkpoint')
    p.add_argument('--vgg_weights', type=str, default=None)
    p.add_argument('--profile_dir', type=str, default=None,
                   help='Write a torch.profiler trace (Chrome JSON) of one '
                        'epoch here')
    p.add_argument('--checkpoint_dir', type=str, default='./checkpoints')
    p.add_argument('--log_dir', type=str, default='./logs')
    return fill(p.parse_args(argv))


def config_from_args(args):
    from mri_superresolution_torch.config import (AugmentConfig, LossConfig,
                                                  ModelConfig, TrainConfig)
    return TrainConfig(
        full_res_dir=args.full_res_dir, low_res_dir=args.low_res_dir,
        model=ModelConfig(model_type=args.model_type,
                          base_filters=args.base_filters,
                          num_blocks=args.num_blocks,
                          initial_alpha=args.initial_alpha),
        loss=LossConfig(ssim_weight=args.ssim_weight,
                        perceptual_weight=args.perceptual_weight,
                        vgg_layer_idx=args.vgg_layer_idx,
                        perceptual_loss_type=args.perceptual_loss_type),
        augment=AugmentConfig(enabled=args.augmentation),
        batch_size=args.batch_size, epochs=args.epochs,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        validation_split=args.validation_split,
        split_by_subject=args.split_by_subject, patience=args.patience,
        seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        log_dir=args.log_dir, use_tensorboard=args.use_tensorboard,
        bf16=not args.no_bf16, num_data_devices=args.num_devices,
        resume=args.resume, vgg_weights=args.vgg_weights,
        profile_dir=args.profile_dir, streaming=args.streaming,
        streaming_prefetch=args.streaming_prefetch,
        streaming_threshold_mb=args.streaming_threshold_mb,
        spatial_shards=args.spatial_shards, remat=args.remat,
        grad_accum=args.grad_accum, ema_decay=args.ema_decay,
        opt_shard=args.opt_shard, qat=args.qat, qat_decay=args.qat_decay,
        save_every_steps=args.save_every_steps)


def local_devices(args) -> list:
    """The devices of this process's ranks: ``--num_devices`` GPUs (0 =
    every visible one, capped at the visible count), or with ``--cpu``
    that many CPU ranks (0 = 1)."""
    import torch
    if args.cpu:
        return [torch.device("cpu")] * max(1, args.num_devices)
    n = torch.cuda.device_count()
    if n == 0:
        return [torch.device("cuda", 0)]   # the trainer raises, naming --cpu
    k = min(args.num_devices, n) if args.num_devices > 0 else n
    return [torch.device("cuda", i) for i in range(k)]


def run_rank(argv, device) -> str:
    """One rank's training (the target ``parallel.multihost`` runs in each
    rank process, its process group joined)."""
    from mri_superresolution_torch.train.trainer import train
    return train(config_from_args(parse_args(argv)), device=device)


def _final_path(cfg) -> str:
    from mri_superresolution_torch.train.checkpoint import checkpoint_paths
    return checkpoint_paths(cfg.checkpoint_dir,
                            cfg.model.model_type)["final"] + ".ckpt"


def main(argv=None) -> str:
    """Parse the flags and train; returns the final checkpoint's path.
    A ``--spatial_shards`` that does not divide the ranks raises
    ValueError before any work. With more than one local rank this
    process starts them and waits; a rank that fails ends the run with
    its exit code (SystemExit)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    from mri_superresolution_torch.parallel import multihost
    from mri_superresolution_torch.train.trainer import check_spatial, train
    cfg = config_from_args(args)
    torchrun = args.multihost and args.coordinator is None
    # under torchrun the process is one rank, on cuda:LOCAL_RANK
    devices = [("cpu" if args.cpu else None)] if torchrun \
        else local_devices(args)
    if not torchrun:
        # the ranks this job will have (under torchrun, the group says)
        hosts = (args.num_processes or 1) if args.multihost else 1
        check_spatial(cfg, len(devices) * hosts)
    if len(devices) == 1 and not args.multihost:
        return train(cfg, device="cpu" if args.cpu else None)
    backend = "gloo" if args.cpu else None
    if len(devices) == 1:
        # this process is the rank: host process_id of num_processes, or
        # torchrun's rank
        dev = multihost.initialize(args.coordinator, args.num_processes,
                                   args.process_id, backend, devices[0])
        try:
            return train(cfg, device=dev)
        finally:
            multihost.shutdown()
    if args.multihost:
        if args.num_processes is None or args.process_id is None:
            raise ValueError("--coordinator needs --num_processes and "
                             "--process_id")
        coordinator = args.coordinator
        world = args.num_processes * len(devices)
        base = args.process_id * len(devices)
    else:
        coordinator = f"127.0.0.1:{multihost.free_port()}"
        world, base = len(devices), 0
    # the local ranks share this process's seed (a default one included)
    rc = multihost.launch("mri_superresolution_torch.cli.train:run_rank",
                          argv + ["--seed", str(args.seed)], devices,
                          coordinator, world, base, backend)
    if rc != 0:
        raise SystemExit(rc)
    return _final_path(cfg)


if __name__ == '__main__':
    main()
