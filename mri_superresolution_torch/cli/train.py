"""Train a model of the zoo on the GPU.

    python -m mri_superresolution_torch.cli.train --full_res_dir hr \
        --low_res_dir lr [--model_type unet|unet_tpu|edsr|simple] \
        [--perceptual_weight 0.1 [--vgg_weights vgg19.npz]] [--epochs 100] \
        [--batch_size 8] [--resume] ...

Takes the flags of the JAX package's ``scripts/train.py`` (reference
scripts/train.py:486-548), with the same defaults and meanings, and
writes the same checkpoints and JSON-line protocol (``--qat``: with the
int8 calibration sidecars). Runs on the card; ``--cpu`` runs on the CPU.
``--remat`` recomputes the model's blocks in the backward (the same
update, less memory); ``--profile_dir`` writes a ``torch.profiler``
Chrome trace of one epoch. Flags of training modes the port does not run
yet (``--spatial_shards`` > 1, ``--opt_shard``, ``--multihost``,
``--num_devices`` > 1) raise an error that names the ROADMAP item that
ports each.
"""

from __future__ import annotations

import argparse
import random


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train MRI quality enhancement model")
    p.add_argument('--full_res_dir', type=str, required=True,
                   help='Directory containing high-quality MRI slices')
    p.add_argument('--low_res_dir', type=str, required=True,
                   help='Directory containing low-quality MRI slices')
    p.add_argument('--model_type', type=str,
                   choices=['unet', 'unet_tpu', 'edsr', 'simple'],
                   default='unet')
    p.add_argument('--base_filters', type=int, default=32)
    p.add_argument('--num_blocks', type=int, default=8,
                   help='edsr only: residual trunk depth')
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
                   help='> 1 is not ported yet (ROADMAP A14)')
    p.add_argument('--grad_accum', type=int, default=1,
                   help='Split each batch into this many sequential '
                        'microbatches, accumulating fp32 gradients: the '
                        'exact full-batch update')
    p.add_argument('--opt_shard', action='store_true',
                   help='not ported yet (ROADMAP A14)')
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
                   help='not ported yet (ROADMAP A14)')
    p.add_argument('--coordinator', type=str, default=None)
    p.add_argument('--num_processes', type=int, default=None)
    p.add_argument('--process_id', type=int, default=None)
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
                   help='> 1 is not ported yet (ROADMAP A14)')
    p.add_argument('--resume', action='store_true',
                   help='Resume from the final or step checkpoint')
    p.add_argument('--vgg_weights', type=str, default=None)
    p.add_argument('--profile_dir', type=str, default=None,
                   help='Write a torch.profiler trace (Chrome JSON) of one '
                        'epoch here')
    p.add_argument('--checkpoint_dir', type=str, default='./checkpoints')
    p.add_argument('--log_dir', type=str, default='./logs')
    return p.parse_args(argv)


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


def main(argv=None) -> str:
    """Parse the flags and train; returns the final checkpoint's path.
    An unported mode raises NotImplementedError before any work."""
    args = parse_args(argv)
    if args.multihost:
        raise NotImplementedError(
            "--multihost is not ported to the PyTorch trainer yet (ROADMAP "
            "A14); the JAX package's scripts/train.py runs it")
    from mri_superresolution_torch.train.trainer import check_supported, train
    cfg = config_from_args(args)
    check_supported(cfg)
    return train(cfg, device="cpu" if args.cpu else None)


if __name__ == '__main__':
    main()
