#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, each reported on its own line; any failure exits non-zero before
the last line is printed:

1. build: compile the CUDA kernels from ``mri_superresolution_torch/csrc``.
2. kernels: each kernel (B1 GroupNorm+LeakyReLU, B2 SSIM, B3 narrow 3x3
   conv, B4 leaky+int8 quantize) at the unet's serving shapes (16 slices of
   256^2, base_filters 32, bf16) against its plain PyTorch version, with
   the tolerance stated; kernel, plain and library times L2-cold from CUDA
   graph replays (``utils/timing.cuda_ms_cold``). B1 checks both of its
   routes (the one-pass kernel the wrapper takes at these shapes, and the
   two-pass kernel) within one bf16 ulp and run to run, and times both.
   B4 checks its stream route and the element kernel code for code on
   every finite bf16 code (C = 1 and 16 with each class of scale alone,
   C = 256 with all of them; both slopes) and at its 20 int8 sites, and
   times both there; its fused route (``gn_quantize``, B1's one-pass
   kernel with an int8 output) is checked code for code against B1 + B4,
   run to run, and against its plain version within one code on under
   0.5% of the elements at the seven DoubleConv conv2 sites, and timed
   against B1 (bf16 out) + B4 run separately. Both B4 routes are also
   checked, not timed, at every other shape the zoo quantizes (the
   serving and volume batches) and the extraction phase's unet one image
   of 128^2 at a time. B1 and B3 are checked at the training, volume,
   tile and extraction-serving (one image of 128^2) batches too. B2 runs
   at one 512^2
   image (``calculate_metrics``) and at batches of 8 (training) and 16
   (serving): within 1e-5 of its plain version, the same bits twice, one
   device kernel a call (``torch.profiler``), then timed twice; and is
   checked at the training phases' 8 images of 256^2 and the extraction
   phase's 50 held-out pairs of 256^2. With
   ``--parent DIR`` the B2 kernel of the checkout in DIR (an older commit)
   is timed before and after, by ``tools/ssim_time.py`` in a process of
   its own. B1's backward runs at the unet's 20 training sites (batch 8
   of 128^2, bf16) on both routes, the one-pass kernel the wrapper takes
   there and the four-pass kernel, against its plain twin (dx within one
   bf16 ulp plus 1e-5, dscale and dbias within rtol 1e-4, the same bits
   twice, 1 and 4 device kernels a call), then L2-cold beside the twin
   and the library's backward; the one-pass route also from two replays
   of a CUDA graph captured on a side stream, and the four-pass route
   through the wrapper at an offset view.
3. main path: ``InferenceEngine`` (full-width unet, seeded random weights,
   bf16) upscales 16 synthetic 256^2 slices to 512^2 and reports metrics
   for one of them; the launch counters must show every kernel ran (B1 20
   and B3 2 per forward, B2 1 per metrics call; all 20 B1 launches on the
   one-pass route). Then slices/s, and a 2-slice batch on the CPU port
   held to the bf16 budget (|dPSNR| <= 0.1 dB, |dSSIM| <= 1e-3 against the
   same ground truth).
4. volume path: the infer_volume CLI, in this process, on a 256 x 256 x
   96 phantom volume stored as int16 with scl_slope 0.5, at batch 32 (3
   batches), with the main path's weights saved as a checkpoint: (a) the
   defaults, (b) ``--serve_raw --out_dtype int16`` (``transpose_io``),
   (c) ``--tta``, (d) a directory of two volumes. Each exits 0 with the
   output's shape, halved in-plane zooms and decoding scl_slope, B1 20
   (one-pass) and B3 2 launches a batch (160 and 16 under TTA); b and d
   against a, slices 48-49 of a and c and one 600^2 slice through
   ``upscale_tiled`` (tile 256) against the CPU port, each within the bf16
   budget; then the stages of a volume's time, and volume slices/s of the
   depth-2 ``upscale_batches`` window against ``map(upscale_batch)`` in
   turns, of runs a, b and c, with the CLI's wall time and peak memory.
5. int8 path: ``InferenceEngine(quant="int8", quant_calib_slices=16)``
   calibrates on the 16 slices, freezes (writing its scales sidecar) and
   serves them int8; an int8 forward must launch B4 13 (all on the stream
   route), ``gn_quantize`` 7, B1 13 (one-pass) and B3 0 times. int8 and bf16 slices/s from this call, PSNR/SSIM of
   both against the same ground truth, and the CPU port's int8 forward
   with the same frozen scales on 2 slices held to |dPSNR| <= 0.1 dB.
6. roll probe: the B5 probe's entry point (``tools/roll_probe.run``) at
   (512, 16384): its three kernels exact against their plain versions, and
   their L2-cold device times (replayed from a CUDA graph) beside
   ``x.clone()`` and ``torch.roll``.
7. training: ``cli.train.main`` (the JAX package's defaults, full width,
   bf16) trains 2 epochs on 40 seeded phantom pairs of 128^2 -> 256^2
   written as PNGs by the port's encoder; its JSON lines, checkpoints,
   finite losses, moved weights and exact launch counts are checked (a
   step: B1 20, B1 backward 20, all one-pass, B3 2, B2 1; a validation
   batch: B1 20, B3 2, B2 1); then one step and one validation batch counted alone, the
   step time (CUDA events, 10 steps after 2 warm-up), one step on the card
   against the CPU port from the same weights and batch (fp32 without
   TF32: loss rtol 1e-4, every gradient 5e-2 relative L2 and their
   median 2e-3; bf16: loss 1e-2,
   gradient cosines >= 0.99), and the final checkpoint served through
   ``load_engine`` with serving's launch counts.
   Then its ``--remat`` and ``--profile_dir`` legs (``remat_profile_path``):
   the train CLI with ``--remat`` on the same pairs and seed (every
   remat block's forward runs again in the backward: a step launches B1
   40, its backward 20, B3 4, B2 1), its best and final checkpoints the
   same bytes as the run without it and its sidecar the same but for
   ``remat``; one step with and without remat at batch 8 of 128^2 and
   16 of 256^2 (launches, the same params after it, step ms and peak
   memory); the train CLI with ``--profile_dir`` (epoch 1's Chrome trace
   names B1's forward and backward kernels and B2's; the same
   checkpoints; epoch 1's seconds beside the run without it). B1's
   backward is checked against its twin at the larger crop's 20 sites
   before any of it.
8. the zoo: ``unet_tpu``, ``edsr`` (8 blocks) and ``simple`` at base
   filters 32. For each, the train CLI for one epoch on the training
   phase's PNGs (unet_tpu: B1 20 and its backward 20 a step; every
   family B2 1 a step and validation batch), the volume phase's volume
   through the infer_volume CLI with its defaults and with ``--quant
   int8`` (writing frozen scales; a calibration forward, then every
   batch int8), then 16 slices of 256^2 through ``upscale_batch`` in
   bf16 and in int8 with those scales: launches a forward (unet_tpu
   bf16 B1 20 and B3 0, int8 B1 13, ``gn_quantize`` 7, B4 13; edsr int8
   B4 18; simple int8 B4 2), slices/s of both in turns with peak memory,
   and 2 of those slices and slices 48-49 of each volume against the CPU
   port at the bf16 budget (edsr and simple in bf16 also all 16 slices
   together at the budget, and each slice alone with its |dSSIM| within
   the larger of 1e-3 and twice the CPU port's bf16 against its fp32 on
   that slice, both logged); then one training step of the family
   counted and timed. Every launch count is exact, and so are B1's
   one-pass and B4's stream launches, from the routes the kernel checks
   found. Before the paths, B1 at unet_tpu's C = 64 sites, forward at
   the serving, volume and training batches ((16, 64, 256^2), (32, 64,
   256^2), (8, 64, 128^2)) and backward (8, 64, 128^2), against the plain
   versions with B1's gates, and timed L2-cold.
9. extraction (the port's data pipeline): 8 synthetic anatomy volumes
   (``tools/quality.make_volume``) at a clinical 192 x 256 in-plane
   matrix, 160 slices, stored int16 with scl_slope, as .nii and .nii.gz,
   6 train and 2 test, through the extract CLI on the card at 25 slices
   and the reference's default target 256^2 (LR 128^2) with
   ``--stage_times``: exit 0, 150 and 50 pairs of the right sizes, the
   stages' ms (read, select and upload, HR pipeline, LR pipeline, fetch,
   PNG write) and slices/s; the test split again without
   ``--stage_times`` (the CLI's own default, which synchronizes only at
   the fetch): slices/s and the same PNG bytes; one volume traced (host
   against device ms); the test split's PNG codes against
   the CPU port's pipelines on the card's noise draws (at least 99.9%
   identical, none more than 1 apart); the unet at full width trained on
   the pairs by the train CLI for 20 epochs at the JAX package's
   defaults (exact launches; the train loss must fall); its final
   checkpoint served over the 50 held-out pairs in bf16, int8 PTQ (scales
   calibrated on train-split slices) and TTA through ``tools/quality.py``,
   beside the bilinear, sharp-bilinear and bicubic baselines, with
   ``metric_suites``' means and deltas and exact launches (B1 all
   one-pass, B4 all on the stream route); bf16 and int8 on the card
   against the CPU port at the bf16 budget on the first 2 held-out pairs
   with content that int8 serves (int8 with the card's frozen scales);
   bf16 on the card against the CPU port on every black pair (LR all
   zero, where B1's groups have zero variance) on max abs difference,
   within ``BLACK_CONTROL_FACTOR`` times the larger of two controls on
   the same pairs: the card with the port's kernels swapped for their
   plain versions (no kernel launched) against the CPU port, and the
   CPU port's bf16 against its fp32.
9b. evaluation (``eval_path``, after phase 9, on its 50 held-out pairs,
   test volumes and checkpoints): ``cli.evaluate --checkpoint`` under
   PyTorch's default TF32 flags (metrics.csv of 200 rows with the JAX
   columns, report.json with the card's name and power limit, exact
   launches: B1 20 and B3 2 a forward, warm-up and the 5 qualitative
   pairs included, B2 once a pair's four methods and once a figure;
   each method's median ms/image), bf16 and the baselines on 2 content
   pairs against the CPU port at the bf16 budget; ``--quant int8`` and
   ``--tta`` over EVAL_SUBSET content pairs; ``--ablation_checkpoints_dir``
   over best and final; ``--ablation_train_configs`` with two loss
   configurations trained for one epoch on the train split in child
   processes on the card; ``cli.test_model`` on the test volumes (square
   canvases, the average metrics); ``cli.test_comparison --seed 0
   --tta`` (the CPU port's pair); the SSIM sweep (two weights, one epoch)
   and ``cli.compare_ssim_detailed`` over its runs; ``cli.visualise_res``
   over the eight volumes (one row); the final checkpoint exported to a
   reference ``.pth`` that serves the same bits, and converted back; the
   TUI under a pty, and its infer command run on the card.
10. the perceptual leg: the unet trained for one epoch with
   ``--perceptual_weight 0.1`` (seeded random VGG19, the trainer's
   warning), one step counted alone, the step's time with cuDNN's TF32
   on and off beside the step without the term, and one step against the
   CPU port, each of the loss's two parts at the training gate (PERF.md
   §2; the perceptual part's fp32 median against a control with the
   port's kernels swapped for their plain versions), with cuDNN's TF32
   off and again on (PyTorch's default; the gate there is ROADMAP C's:
   the bf16 cosines, and each part's fp32 median against the control in
   that mode, the worst tensors read beside the control's).
11. quantization-aware training (``qat_path``; it and phase 12 run right
   after phase 7, whose pairs and checkpoint they use): one bf16 QAT step
   at batch 8 of 128^2 -> 256^2 on the card against the CPU port from the
   same weights and running amax, which starts at half the batch's
   calibration (loss within 1e-2, gradient cosines >= 0.99, the EMA rule
   on each device, the updated amax within ``QAT_AMAX_RTOL``, the
   foreground flag equal),
   its launches counted alone (B1 20, its backward 20 one-pass, B3 2, B2
   1) and its time; the train CLI with ``--qat`` for 2 epochs on the
   training phase's pairs, then ``--qat --resume`` of the training
   phase's bf16 checkpoint for 2 more (each: exact launches with its one
   calibration forward, a train loss that falls, and ``.calib.json``
   sidecars beside best and final, 20 sites of finite scales > 0); the
   QAT checkpoint's fakequant forward against its int8 forward with the
   same scales on the serving batch, within 0.1 dB PSNR.
12. the serving daemon (``serve_path``): ``serve_http`` in this process,
   three backends one after another. bf16: 16 client threads (in a
   process of their own; the engine warm at every padded batch) post 128
   slices of 256^2 (each 4 alone and a stack of 4); every output against
   the same slice through ``upscale_batch`` at the bf16 budget,
   ``/metrics`` with 128 requests, no error and none abandoned, B1 20
   (one-pass) and B3 2 launches a batch; HTTP slices/s and request
   latency p50/p99 beside ``upscale_batch``'s slices/s. ``--serve_raw
   --out_dtype int16`` (the volume phase's checkpoint, batch 32): the
   volume phase's volume as .nii, .nii.gz and a .nii.gz of two members,
   each against that phase's CLI output (header fields, voxels within
   one code), and one non-square raw /upscale in the transposed layout.
   int8 from the QAT checkpoint's sidecar: int8 from the first batch
   (``quant_batches``), B1 13, ``gn_quantize`` 7, B4 13 a batch; a stack
   of 16 and one slice, each slice against the same engine's
   ``upscale_batch`` at the bf16 budget, and against the checkpoint's
   fakequant forward within 0.1 dB PSNR (the int8 budget), its bf16
   engine read beside them. Then
   ``cli/serve.py`` as a process of its own: /healthz, one /upscale at
   the bf16 budget, and a SIGTERM while a request waits in the batch
   window: the request completes, the process exits 0.
13. portable serving artifacts (``artifact_path``, after phase 12): the
   training phase's train CLI run again from its seed and pairs, its
   checkpoints against that phase's byte for byte (``train_repeat``);
   the export CLI, one process a mode, all started together (plain at
   256^2 and 256 x 192, tta at 256^2 and raw int16 at the volume's 256^2
   from the volume phase's checkpoint; int8 from the QAT checkpoint's
   sidecar): seconds and MiB each; a fresh process loads each and
   serves the phantom batch through it (int8 also a black batch, raw
   the volume's first 16 stored slices), with each load's seconds and
   first call's ms and no module of the model zoo, the trainer or the
   engine imported; each output against the port's engine on the same
   checkpoint bit for bit (tta against the engine's on-card TTA), and
   the launches a batch (plain B1 20 and B3 2; int8 B1 13,
   ``gn_quantize`` 7, B4 13; the black batch the fallback's B1 20 and
   B3 2); ``cli.infer_volume --artifact`` on the volume voxel for voxel
   against the volume phase's run (b) from the checkpoint;
   ``upscale_batch`` slices/s of the artifact beside the engine's in
   turns; ``cli.serve --artifact`` over HTTP (a stack of 4 and one
   slice at the bf16 budget against the artifact, exit 0 on SIGTERM);
   the card-made artifact on the CPU against the CPU port at the bf16
   budget.
14. data parallelism and ``phase_final`` (``dp_phase_path``): (a) the
   train CLI as the training phase ran it, with ``--multihost
   --coordinator 127.0.0.1:<port> --num_processes 1 --process_id 0
   --opt_shard``: NCCL on the card at a world of one, every collective
   run, the checkpoints' SHA-256 those of the training phase's plain run;
   (b) two rank processes on ``cuda:0`` over gloo (asked for by name:
   NCCL refuses two ranks on one device) through
   ``tools/dp_step.run_rank`` at the training batch (8 of 128^2, 4 a
   rank): bf16 the same bits as the ranks run as threads of this process
   (each rank's rows at its batch, the fp32 partial gradients added),
   ``--opt_shard`` the replicated update's bits, the ranks' params
   bit-identical, fp32 (TF32 off) within 1e-5 relative L2 a tensor of one
   process on the same rows at the ranks' batch of 4, and its gradient
   within 2x that process's own gap to one on the global batch of 8
   (cuDNN's fp32 convs differ between the batch sizes), one rank-step's
   launches (B1 20, backward
   20, B3 2, B2 1), step and all-reduce ms a rank ("gloo, one card, not
   representative"); (c) ``InferenceEngine(devices=[cuda:0, cuda:0])``
   at 16 x 256^2 in bf16, frozen int8 and TTA: each half bit-equal to the
   one-device engine at batch 8, launches a chunk B1 20 and B3 2 (int8:
   B1 13, gn_quantize 7, B4 13; TTA eight times B1 20 and B3 2); (d)
   ``UNetSuperRes(phase_final=True)`` at full width on 16 x 256^2: fp32
   within rtol 1e-4 (atol 1e-5) of the dense forward, bf16 at the bf16
   budget against it and against the CPU port's phase_final (two
   slices), B1 19 launches a forward (its two aligned phase norms at
   C = 64 among them) and no B3, forward ms beside the dense forward's.
   Every kernel is first held against its plain version at the shapes
   this phase adds: B1 and B3 at a rank's batch (4 of 128^2) and a
   device's chunk (8 of 256^2), B1's backward and B2 (4 of 256^2) at a
   rank's batch, B4 and its fused route at a chunk's 20 sites, B1 in
   fp32 at the phase_final forward's five shapes.
15. row-sharded serving (``spatial_path``, run after the perceptual
   phase; its export and the artifact's client start in the background
   after phase 14) on ``cuda:0`` named 2 and 4 times: (a) B3 on the 1-row haloed blocks of the unet's two narrow
   sites (8 x 1024^2, bf16 and fp32) against its plain version, the
   cropped rows gathered bit-equal to the dense kernel's, and B4's
   stream route at every family's int8 sites on a shard (4 x 256^2 over
   2), code for code; (b) the full-width unet at 8 x 512^2 over 2 and 4
   shards through ``InferenceEngine(spatial_shards=n)`` against the
   one-device engine: fp32 within rtol 1e-4, atol 3e-5; bf16 within 0.1
   dB PSNR of dense bf16 against the HR truth and no more than 0.1 dB
   below it against the fp32 truth; B3 2n launches a forward and no
   other kernel; ms a batch beside the one-device engine's ("one card,
   not representative"); (c) each family at full width on 4 x 256^2 over
   2: a sidecar calibrated on the batch, spatial and dense int8 served
   from it (unet and unet_tpu within the JAX quality contract against
   the fp32 truth, edsr and simple bit-equal), B4 one stream launch a
   site and shard, the fp32 calibration amax within rtol 1e-5, atol
   1e-6 of the dense one; (d) streaming calibration on the spatial
   engine and the bf16 TTA ensemble against the dense ensemble (bf16
   budget); (e) ``cli.infer_volume --num_devices 2 --spatial_shards 2``
   on a 128 x 128 x 8 volume against the run without them (bf16
   budget), ``cli.serve`` with those flags answering one /upscale bit
   for bit as the engine, and ``cli.export_serving --spatial_shards 2``
   whose artifact a fresh process serves, with no model code, bit for
   bit as the spatial engine.
16. row-sharded training (``spatial_train_path``): B3 on the 1-row
   haloed blocks of the training batch over 2 shards (8 x 130 x 256 at
   both narrow sites, bf16 and fp32 against the plain version, the
   cropped rows bit-equal to the dense kernel's); the full-width unet on
   the training batch (8 x 128^2 -> 256^2), one step of the spatial
   trainer (``tools/sp_step``) over two gloo ranks on ``cuda:0`` as a
   (1 data x 2 space) grid, in fp32 (TF32 off) and bf16, against the
   same step over the in-process ``SpaceGroup`` of ``[cuda:0, cuda:0]``
   (the metrics the same bits, fp32 gradients within 1e-6, bf16
   gradients within 8 bf16 ulps of each tensor's largest magnitude) and the
   one-device dense step on the same batch (fp32 loss within rtol 1e-5
   and gradients within max abs 1e-4; bf16 loss within rtol 1e-3); the
   ranks' params the same bits; each rank's step launches B3 2 and
   nothing else (B1, B2 and B4 are off the sharded path), the in-process
   group 4; ms a bf16 step of a rank beside the one-device step's ("one
   card, not representative"); then, in the same two ranks, the train
   CLI's rank (``cli.train.run_rank``, as ``--num_devices 2
   --spatial_shards 2`` starts them on two cards) for one epoch on the
   training phase's pairs, its checkpoint served by the dense engine
   (finite, the HR shape).
17. EMA, the mid-epoch resume and streaming (``ema_path``), on the
   training phase's pairs at its width and epochs through the train
   CLI: ``--ema_decay 0.9 --save_every_steps 3``, its ``raw_params`` the
   training phase's final params by SHA-256 and its served params apart
   from them; the same with ``--augmentation`` (augmentation drawn on the
   card from a generator seeded by seed, epoch and batch), and again
   preempted through ``progress_cb`` at epoch 1's first batch and resumed
   with ``--resume`` from its step checkpoint (epoch 0, cursor 3): every
   array of the final checkpoint (params, ``raw_params``, Adam's count
   and moments) the same bytes as the uninterrupted run's, the two runs'
   launches exact; ``--streaming on`` without EMA, its final checkpoint
   the training phase's bytes; 10 trainer steps at 8 x 128^2 with EMA
   0.9, fp32 (TF32 off) and bf16, each step's live weights read to the
   host and the EMA recomputed there in float64 (``tools/ema_quality.
   ema_recompute_gap``): every tensor within 1e-6 of its largest
   magnitude; a step with EMA launches what one without it does (B1 20,
   its backward 20 one-pass, B3 2, B2 1); the EMA checkpoint served
   through ``load_engine`` on the card and on the CPU port at the bf16
   budget.
18. the daemon soak (``soak_path``): ``tools/soak_server``'s logic at
   full width (base filters 32, 256^2 -> 512^2, int16 on the raw path),
   6 slice clients and 2 volume clients (24 slices) for 30 s in this
   process: its five books checks (``check_books``), the aggregate
   slices/s, p50 and p99 by client kind, the batch-size histogram and
   ``peak_pending``; B1 20 (one-pass) and B3 2 launches an engine
   forward; each client's first response against ``upscale_batch`` on
   the same slices at the bf16 budget (an fp32 engine's output the
   truth), bit-equality logged; B1 and B3 against their plain versions
   at the largest padded batch the soak formed.
19. the remaining quality harnesses (``harness_path``), each through its
   ``main`` on the extraction phase's pairs: ``tools/ema_quality
   --models unet --decays 0.9 --epochs 2``, ``tools/vgg_quality --epochs
   2`` and ``tools/edsr_convergence --epochs 4 --patience 2``: each
   report has the JAX tool's keys and finite rows, the EMA run's live
   weights (``finalraw``) are the control run's final params by SHA-256,
   the edsr protocol records the patience and a best checkpoint exists,
   and B1, its backward, B2 and B3 launched; ``tools/fetch_vgg_weights
   --pth`` on a seeded torchvision-shaped VGG19 state_dict, its ``.npz``
   giving on the card the features of ``VGG19Features`` built from the
   same arrays.
20. the ``kernels`` JSON line, the card's name and power limit, and the
   device JSON line last. No kernel's time (and no B5 time, library calls
   included) may fall below its bound: that would mean a broken yardstick.
   The B3 times are bf16, the tensor-core kernel. B1's row gives the
   one-pass route's time, and the two-pass route's as ``earlier_ms``;
   B4's row its stream route over the 13 sites it serves on the int8 path,
   the element kernel's there as ``earlier_ms``, and both over all 20
   sites as ``all_20_sites``; the ``gn_quantize`` row the fused route over
   the seven conv2 sites, and B1 + B4 there as ``earlier_ms``; B2's row
   the batch of 8 (the batch of 16 beside it as ``batch16``), and the one
   image on a row of its own (with ``--parent``, the older kernel's time
   as ``earlier_ms``); B1's backward row the one-pass route at its 20
   training sites, the four-pass kernel's time there as ``earlier_ms``,
   and the training run's launches and one-pass launches. B1's and B3's
   rows also carry the volume path's default run's launches
   (``volume_launches``); every row the zoo phase's (``zoo_launches``),
   the extraction phase's (``extract_launches``, B5's rows too), the
   perceptual training run's (``perceptual_launches``), the QAT phase's
   two train CLI runs' (``qat_launches``), the serving phase's three
   in-process daemons' (``serve_launches``) and the artifact phase's
   (``artifact_launches``: a plain and an int8 batch and the volume
   through the raw artifact), the eval phase's (``eval_launches``), the
   data-parallel phase's (``dp_launches``: the world-of-one training run,
   both ranks' checked step and the two-device engine's three batches)
   and ``phase_final``'s two forwards (``phase_launches``), the spatial
   phase's counted forwards (``spatial_launches``: its engines' bf16
   and fp32 batches and the four families' int8 batches), the spatial
   training phase's two ranks' fp32 and bf16 steps
   (``spatial_train_launches``), the EMA phase's (``ema_launches``), the
   soak's daemon (``soak_launches``) and the harness phase's three tools
   (``harness_launches``), and B1's and its backward's rows their C = 64
   times (``c64``). A ``wall`` line
   before it gives the script's seconds.

Needs one CUDA card; without one it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gzip
import io
import json
import logging
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# the port itself, from the checkout this script sits in: without it the
# script fails here, before it prints anything
from mri_superresolution_torch import kernels, native, nifti
from mri_superresolution_torch.cli import compare_ssim_detailed as \
    detailed_cli
from mri_superresolution_torch.cli import evaluate as eval_cli
from mri_superresolution_torch.cli import extract as extract_cli
from mri_superresolution_torch.cli import test_comparison as comparison_cli
from mri_superresolution_torch.cli import test_model as test_model_cli
from mri_superresolution_torch.cli import test_ssim_weights as sweep_cli
from mri_superresolution_torch.cli import ui as tui
from mri_superresolution_torch.cli import visualise_res as res_cli
from mri_superresolution_torch.cli import infer_volume as volume_cli
from mri_superresolution_torch.cli import train as train_cli
from mri_superresolution_torch.data.extraction import (
    extract_from_nifti, find_nifti_files, generate_bids_identifier,
    generate_filename, hr_pipeline, lr_pipeline, pick_slices, sub_seed,
    to_uint8)
from mri_superresolution_torch.config import (InferConfig, LossConfig,
                                              ModelConfig)
from mri_superresolution_torch.infer import (InferenceEngine, load_engine,
                                             serve_http)
from mri_superresolution_torch.kernels import _build
from mri_superresolution_torch.kernels.conv3x3 import conv3x3, conv3x3_plain
from mri_superresolution_torch.kernels.groupnorm import (
    gn_quantize, gn_quantize_plain, group_norm_leaky,
    group_norm_leaky_backward, group_norm_leaky_backward_fourpass,
    group_norm_leaky_backward_plain, group_norm_leaky_plain,
    group_norm_leaky_twopass, onepass_backward_plan, onepass_plan)
from mri_superresolution_torch.kernels.leaky_quantize import (
    leaky_quantize, leaky_quantize_generic, leaky_quantize_plain)
from mri_superresolution_torch.kernels.ssim import (
    flops_per_pixel as ssim_flops_per_pixel, ssim_per_sample,
    ssim_per_sample_plain)
from mri_superresolution_torch.models import build_model, param_count
from mri_superresolution_torch.models import quant_forward
from mri_superresolution_torch.models import vgg as vgg_mod
from mri_superresolution_torch.ops.metrics import psnr
from mri_superresolution_torch.ops.kspace import draw_kspace_noise
from mri_superresolution_torch.ops.normalize import normalize_slices
from mri_superresolution_torch.ops.quant import FOREGROUND_INTENSITY
from mri_superresolution_torch.ops.ssim import ssim
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.parallel import multihost as multihost_mod
from mri_superresolution_torch.tools import (convert_torch_checkpoint,
                                             dp_step, edsr_convergence,
                                             ema_quality,
                                             export_torch_checkpoint,
                                             fetch_vgg_weights, grad_gap,
                                             quality, roll_probe,
                                             soak_server, sp_step,
                                             vgg_quality)
from mri_superresolution_torch.tools.profile_step import trace_calls
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.train import trainer
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.subproc import child_env
from mri_superresolution_torch.utils.timing import (cuda_ms, cuda_ms_cold,
                                                    l2_cold_copies)

# H100 SXM published peaks (dense): memory 3.35 TB/s, bf16 tensor cores
# 989 TFLOP/s, fp32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_RTOL = 2.0 ** -7          # one bf16 ulp, relative
# int8 codes against a plain version that rounds differently before the
# quantize: the JAX package's int8 probe bound (tools/bench_int8_probe4.py)
CODES_MAX_DIFF, CODES_MAX_FRAC = 1, 0.005
BATCH, LR, BASE_FILTERS = 16, 256, 32
PROBE_ROWS, PROBE_LANES = 512, 16384
# B2: one 512^2 image (calculate_metrics), the training batch (the JAX
# package's default TrainConfig.batch_size) and the serving batch
B2_SHAPES = ((1, 512, 512), (8, 512, 512), (16, 512, 512))
B2_ROW_SHAPE = (8, 512, 512)
SSIM_TIME = Path(__file__).resolve().parent / "mri_superresolution_torch" / \
    "tools" / "ssim_time.py"
# written by the int8 engine when its scales freeze; build/ is not
# committed
SCALES_PATH = Path(__file__).resolve().parent / "build" / "chip_smoke" / \
    "int8_scales.json"
# the training phase: the JAX package's TrainConfig defaults (batch 8, lr
# 1e-4, weight decay 1e-5, ssim_weight 0.3, bf16) on LR 128^2 -> HR 256^2
# (ExtractConfig.target_size), a PNG set of seeded phantoms written there
TRAIN_BATCH, TRAIN_LR, TRAIN_PAIRS, TRAIN_EPOCHS, TRAIN_SEED = 8, 128, 40, 2, 0
TRAIN_DIR = SCALES_PATH.parent / "train"
STEP_ITERS = 10
# the volume phase: a 256 x 256 x 96 phantom volume stored as int16 with
# scl_slope 0.5, served at batch 32 (3 batches, so the depth-2 window
# turns over); two of its slices against the CPU port; one 600^2 slice
# through upscale_tiled at tile 256 (9 tiles)
VOL_HW, VOL_SLICES, VOL_BATCH, VOL_SLOPE = 256, 96, 32, 0.5
VOL_CPU_SLICES = slice(48, 50)
TILED_HW, TILE, HALO = 600, 256, 16        # HALO: upscale_tiled's default
VOL_DIR = SCALES_PATH.parent / "volume"
VOL_SEED = 3
# unet_tpu's three final-stage GroupNorm sites (C = 2f at the input
# resolution): the forward at the serving, training and volume batches
# (timed at the first), the backward at the training batch
C64_FWD = tuple((b, 2 * BASE_FILTERS, hw, hw) for b, hw in (
    (BATCH, LR), (TRAIN_BATCH, TRAIN_LR), (VOL_BATCH, VOL_HW)))
C64_BWD = (TRAIN_BATCH, 2 * BASE_FILTERS, TRAIN_LR, TRAIN_LR)
# the zoo phase: the other three families at the train CLI's full width
# (base filters 32, edsr 8 blocks), and their launches a forward
ZOO_DIR = SCALES_PATH.parent / "zoo"
ZOO_FAMILIES = ("unet_tpu", "edsr", "simple")
EDSR_BLOCKS = 8
# the families held slice by slice over the whole serving batch (their
# bf16 convs sat closest to the budget on 2 slices, PR 10): each slice's
# |dSSIM| card against CPU port within the larger of the budget's 1e-3
# and twice the CPU port's own bf16 against fp32 on that slice
ZOO_ALL_SLICES = ("edsr", "simple")
ZOO_SLICE_SSIM_FLOOR, ZOO_SLICE_CONTROL_FACTOR = 1e-3, 2.0
ZOO_BF16_LAUNCHES = {"unet_tpu": {"group_norm_leaky": 20}, "edsr": {},
                     "simple": {}}
ZOO_INT8_LAUNCHES = {
    "unet_tpu": {"group_norm_leaky": 13, "gn_quantize": 7,
                 "leaky_quantize": 13},
    "edsr": {"leaky_quantize": 2 * EDSR_BLOCKS + 2},
    "simple": {"leaky_quantize": 2}}
PERC_WEIGHT = 0.1
# the extraction phase: 8 synthetic anatomy volumes at a clinical matrix
# (192 x 256 in-plane, non-square so that the letterbox pads; 160
# slices), stored int16 with scl_slope, .nii and .nii.gz; 6 train and 2
# test volumes, 25 slices each, at the reference's default target 256^2
# (LR 128^2); the unet trained on them for EXTRACT_EPOCHS epochs
EXTRACT_DIR = SCALES_PATH.parent / "extract"
EXTRACT_SHAPE, EXTRACT_SLOPE = (192, 256, 160), 0.25
EXTRACT_VOLUMES = {"train": 6, "test": 2}
EXTRACT_SLICES, EXTRACT_TARGET, EXTRACT_SEED = 25, 256, 0
EXTRACT_EPOCHS = 20
# B2 checked, not timed: the training phases' batch (8 of 256^2), the
# extraction phase's metric batch (its 50 held-out pairs of 256^2) and the
# eval phase's: the four methods of a pair (cli.evaluate,
# cli.test_comparison), bicubic and the model of a qualitative figure, and
# one image (cli.test_model's calculate_metrics)
B2_CHECK_SHAPES = ((8, 256, 256), (4, 256, 256),    # 2 ranks of the 8
                   (EXTRACT_VOLUMES["test"] * EXTRACT_SLICES,
                                   EXTRACT_TARGET, EXTRACT_TARGET),
                   (4, EXTRACT_TARGET, EXTRACT_TARGET),
                   (2, EXTRACT_TARGET, EXTRACT_TARGET),
                   (1, EXTRACT_TARGET, EXTRACT_TARGET))
# the training phase's --remat leg: peak memory and step time with and
# without it at the training batch and at a larger crop (the serving
# batch, 16 of 256^2 -> 512^2), whose B1 backward sites are checked too;
# the --profile_dir leg's trace must name B1's two kernels and B2's
REMAT_SHAPES = ((TRAIN_BATCH, TRAIN_LR), (BATCH, LR))
PROFILE_KERNELS = ("gn_onepass_kernel", "gn_onepass_bwd_kernel",
                   "ssim_band_kernel")
# the eval phase, on the extraction phase's held-out pairs, test volumes
# and checkpoints: --quant int8, --tta, the two ablation modes and the
# SSIM sweep over EVAL_SUBSET content pairs; the sweep's weights; the
# metrics.csv columns of the JAX package's evaluate.py (the metrics, the
# method, its time, the image, the checkpoint's label and details)
EVAL_DIR = SCALES_PATH.parent / "eval"
EVAL_SUBSET = 8
EVAL_WEIGHTS = ("0.3", "0.7")
EVAL_COLUMNS = ["ssim", "psnr", "mse", "rmse", "mae", "method", "time",
                "image", "checkpoint", "epochs", "batch_size",
                "learning_rate", "weight_decay", "ssim_weight",
                "perceptual_weight", "base_filters", "val_loss", "val_ssim",
                "epoch"]
EVAL_METHODS = ("bicubic", "bilinear", "sharp_bilinear", "unet")
# the extraction phase's black pairs (LR all zero): card against CPU port
# bf16 outputs, max abs difference, held to BLACK_CONTROL_FACTOR times
# the larger of two controls on the same checkpoint: the card's bf16 with
# the port's kernels swapped for their plain versions against the CPU
# port (what PyTorch's own CUDA ops move), and the CPU port's bf16
# against its fp32 (what the precision moves). The reading follows the
# checkpoint, which moved between chip calls: read on an NVIDIA H100
# 80GB HBM3 at 700 W over ten checkpoints, 3.2e-3 to 1.51e-2, with the
# precision control 2.3e-3 to 1.1e-2 and, on two, ratios of 0.50 and
# 0.77 to the larger control; a fault in B1's zero-variance groups is
# off by the output's scale (~0.2)
BLACK_CONTROL_FACTOR = 2.0
# card against CPU port codes (PNG): share identical, largest difference
CODES_SAME_MIN, CODES_DIFF_MAX = 0.999, 1
# the QAT phase: the train CLI's default qat_decay; the step's running
# amax starts at QAT_AMAX_START of the batch's calibration, so that the
# step moves it (a step that left it as it was fails the EMA rule, held
# on each device to QAT_RULE_RTOL); the updated amax, card against CPU
# port, within 1e-2 relative: the batch statistic's share of it is ~4%,
# and the unet's quantizers flip codes between two devices, which moves
# a site's statistic by up to 8% in a channel (1.65e-3 read at a 2%
# share, NVIDIA H100 80GB HBM3, 700 W; tests/test_torch_qat.py); the
# --qat --resume fine-tune's epochs
QAT_DIR = SCALES_PATH.parent / "qat"
QAT_DECAY, QAT_AMAX_RTOL, QAT_FT_EPOCHS = 0.98, 1e-2, 2
QAT_AMAX_START, QAT_RULE_RTOL = 0.5, 1e-6
# the serving phase: 16 clients of 8 slices of 256^2 each (4 alone and a
# stack of 4); one non-square raw slice through /upscale
SERVE_DIR = SCALES_PATH.parent / "serve"
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_SEED = 16, 8, 6
NONSQ_W = 192
# the artifact phase: what each mode exports, from which phase's
# checkpoint, and the inputs the fresh process serves through it (the
# phantom serving batch, its 256 x 192 crop, a black batch, the volume
# phase's first 16 stored slices in the transposed layout)
ART_DIR = SCALES_PATH.parent / "artifact"
ART_MODES = {
    "plain": ("vol", [f"--shapes={LR}x{LR},{LR}x{NONSQ_W}"],
              ("phantom", "phantom_192")),
    "tta": ("vol", [f"--shapes={LR}x{LR}", "--mode=tta"], ("phantom",)),
    "int8": ("qat", [f"--shapes={LR}x{LR}", "--mode=int8"],
             ("phantom", "black")),
    "raw": ("vol", [f"--shapes={VOL_HW}x{VOL_HW}", "--serve_raw",
                    "--out_dtype=int16"], ("raw",))}
ART_LAUNCHES = {"plain": {"group_norm_leaky": 20, "conv3x3": 2},
                "int8": {"group_norm_leaky": 13, "gn_quantize": 7,
                         "leaky_quantize": 13}}
ART_RATE_ITERS = 30


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def within(got: torch.Tensor, want: torch.Tensor, rtol: float,
           atol: float) -> tuple:
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= atol + rtol * w.abs()).all())
    return ok, float(err.max())


def gn_sites(b: int, lr: int, f: int):
    """(B, C, H, W) of the unet's 20 GroupNorm+LeakyReLU sites, with counts."""
    return [((b, f, lr, lr), 2 + 3),                       # inc, up3
            ((b, 2 * f, lr // 2, lr // 2), 2 + 3),         # down1, up2
            ((b, 4 * f, lr // 4, lr // 4), 2 + 3),         # down2, up1
            ((b, 8 * f, lr // 8, lr // 8), 2),            # down3
            ((b, f // 2, 2 * lr, 2 * lr), 3)]             # final stage


def other_batches() -> tuple:
    """(batch, input side, name) of what the later phases run besides the
    main path's batch: the training batch (its forwards), the volume's
    batches, the tiles of the volume phase's one tiled slice, and the
    extraction phase's serving, one LR image of 128^2 at a time (int8
    calibration, bf16, int8 and each TTA pass)."""
    stride = TILE - 2 * HALO
    tiles = len(range(0, TILED_HW - 2 * HALO, stride)) ** 2
    return ((TRAIN_BATCH, TRAIN_LR, "training batch"),
            (VOL_BATCH, VOL_HW, "volume batch"),
            (tiles, TILE, f"{tiles} tiles of upscale_tiled"),
            (1, EXTRACT_TARGET // 2, "extraction serving"))


def b1_inputs(shape, dev, gen) -> tuple:
    x = torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    c = shape[1]
    return (x, torch.randn(c, generator=gen, device=dev),
            torch.randn(c, generator=gen, device=dev))


def b1_check(x, g, b, served_by: str) -> float:
    """Both routes of B1 (the one-pass kernel the wrapper takes at the
    unet's shapes, and the two-pass kernel) against the plain version and
    run to run; the one-pass route's max abs error."""
    shape = tuple(x.shape)
    plan = onepass_plan(x, torch.empty_like(x))
    if plan is None:
        raise AssertionError(f"B1's one-pass route does not take {shape}")
    want = group_norm_leaky_plain(x, g, b)
    worst = 0.0
    for route, fn in (("onepass", group_norm_leaky),
                      ("twopass", group_norm_leaky_twopass)):
        got = fn(x, g, b)
        ok, err = within(got, want, BF16_RTOL, 1e-5)
        same = torch.equal(got, fn(x, g, b))
        log("kernel_check", kernel="B1", route=route, shape=list(shape),
            served_by=served_by, dtype="bf16", plan=plan._asdict(),
            max_abs_err=err, rtol=BF16_RTOL, atol=1e-5,
            run_to_run_equal=same, ok=ok)
        if not (ok and same):
            raise AssertionError(f"B1 ({route}) disagrees with its plain "
                                 f"version at {shape} (max abs err "
                                 f"{err}) or from run to run ({same})")
        if route == "onepass":
            worst = err
    return worst


def check_b1(dev, gen) -> dict:
    """B1 at the unet's five GroupNorm shapes (unet_tpu's backbone takes
    the first four): both routes against the plain version and run to
    run, at the main path's batch and at ``other_batches``; then, at the main path's batch, every time
    L2-cold from CUDA graph replays, the library's GroupNorm + LeakyReLU
    timed the same way."""
    keys = ("ms", "earlier_ms", "plain_ms", "library_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    worst, bound_by = 0.0, "bytes"
    for n, lr, served_by in other_batches():
        for shape, _ in gn_sites(n, lr, BASE_FILTERS):
            worst = max(worst, b1_check(*b1_inputs(shape, dev, gen),
                                        served_by))
    for shape, count in gn_sites(BATCH, LR, BASE_FILTERS):
        x, g, b = b1_inputs(shape, dev, gen)
        worst = max(worst, b1_check(x, g, b, "main path"))
        gb, bb = g.to(torch.bfloat16), b.to(torch.bfloat16)
        xs = l2_cold_copies(x)
        k = cuda_ms_cold(lambda t: group_norm_leaky(t, g, b), xs)
        two = cuda_ms_cold(lambda t: group_norm_leaky_twopass(t, g, b), xs)
        p = cuda_ms_cold(lambda t: group_norm_leaky_plain(t, g, b), xs)
        lib = cuda_ms_cold(
            lambda t: F.leaky_relu(F.group_norm(t, 8, gb, bb), 0.2), xs)
        del xs
        bnd, bound_by = bound_ms(2 * x.numel() * x.element_size(),
                                 10 * x.numel(), torch.bfloat16)
        log("kernel_time", kernel="B1", shape=list(shape), sites=count,
            kernel_ms=k, twopass_ms=two, plain_ms=p, library_ms=lib,
            bound_ms=bnd, bound_share=bnd / k, twopass_bound_share=bnd / two,
            timing="L2-cold, CUDA graph replays")
        below = {name: v for name, v in (("onepass", k), ("twopass", two),
                                         ("plain", p), ("library", lib))
                 if v < bnd}
        if below:
            raise AssertionError(f"B1 times below their {bnd} ms bound at "
                                 f"{shape}: {below}")
        for key, v in zip(keys, (k, two, p, lib, bnd)):
            tot[key] += count * v
    log("kernel_total", kernel="B1", sites=20, **tot,
        bound_share=tot["bound_ms"] / tot["ms"])
    return {**tot, "max_abs_err": worst, "bound_by": bound_by}


def b3_inputs(n, ci, co, hr, dev, gen) -> tuple:
    x = torch.randn((n, ci, hr, hr), generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = (torch.randn((co, ci, 3, 3), generator=gen, device=dev)
         / math.sqrt(9 * ci)).to(torch.bfloat16)
    return x, w


def b3_check(x, w, served_by: str) -> float:
    """B3 against its plain version and run to run; the max abs error."""
    got = conv3x3(x, w)
    ok, err = within(got, conv3x3_plain(x, w), BF16_RTOL, 1e-4)
    same = torch.equal(got, conv3x3(x, w))
    log("kernel_check", kernel="B3", shape=list(x.shape), cout=w.shape[0],
        served_by=served_by, dtype="bf16", max_abs_err=err, rtol=BF16_RTOL,
        atol=1e-4, run_to_run_equal=same, ok=ok)
    if not (ok and same):
        raise AssertionError(f"B3 disagrees with its plain version at "
                             f"{list(x.shape)} -> {w.shape[0]}: max abs err "
                             f"{err}, run to run equal {same}")
    return err


def check_b3(dev, gen) -> dict:
    """B3 at the unet's two sites against its plain version and run to
    run, at the main path's batch and at ``other_batches``; then, at the main path's batch, timed L2-cold beside the plain
    version and the library's convolution."""
    f = BASE_FILTERS
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    worst, bound_by = 0.0, "bytes"
    sites = ((f, f // 2), (f // 2, f // 2))           # final_up_conv, conv1
    for n, lr, served_by in other_batches():
        for ci, co in sites:
            worst = max(worst, b3_check(
                *b3_inputs(n, ci, co, 2 * lr, dev, gen), served_by))
    hr = 2 * LR
    for ci, co in sites:
        x, w = b3_inputs(BATCH, ci, co, hr, dev, gen)
        worst = max(worst, b3_check(x, w, "main path"))
        xs = l2_cold_copies(x)
        k = cuda_ms_cold(lambda t: conv3x3(t, w), xs)
        p = cuda_ms_cold(lambda t: conv3x3_plain(t, w), xs)
        lib = cuda_ms_cold(lambda t: F.conv2d(t, w, padding=1), xs)
        del xs
        out_numel = BATCH * co * hr * hr
        bnd, bound_by = bound_ms(
            (x.numel() + w.numel() + out_numel) * 2,
            2.0 * out_numel * 9 * ci, torch.bfloat16)
        log("kernel_time", kernel="B3", shape=list(x.shape), cout=co,
            kernel_ms=k, plain_ms=p, library_ms=lib, bound_ms=bnd,
            bound_share=bnd / k, library_over_kernel=lib / k,
            timing="L2-cold, CUDA graph replays")
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                       ("bound_ms", bnd)):
            tot[key] += v
    return {**tot, "max_abs_err": worst, "bound_by": bound_by}


def device_kernels(fn, tries: int = 8) -> list:
    """Names of the device kernels one call of ``fn`` runs, from
    ``torch.profiler``. Now and then the profiler records no device event
    at all for a call (seen on the H100 machine for B2, and for B1's
    backward three traces in a row); a trace with none is taken again,
    each on one call of its own after a pause, up to ``tries`` times."""
    names = []
    for i in range(tries):
        if i:
            time.sleep(0.2 * i)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def b2_bound(shape) -> tuple:
    # one read of both images, one fp32 write an image; the least fp32
    # work of the function (kernels/ssim.flops_per_pixel, an FMA counts 2)
    b, h, w = shape
    return bound_ms(2 * b * h * w * 4 + 4 * b,
                    float(ssim_flops_per_pixel(11)) * b * h * w,
                    torch.float32)


def parent_b2_ms(parent: str) -> dict:
    """B2's L2-cold times, by shape, of the port in the checkout ``parent``
    (an older commit), from ``tools/ssim_time.py`` in a process of its
    own, which builds that checkout's kernels."""
    shapes = ["x".join(map(str, s)) for s in B2_SHAPES]
    r = subprocess.run([sys.executable, str(SSIM_TIME), "--tree", parent,
                        "--shapes", *shapes], capture_output=True, text=True,
                       timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"timing B2 in {parent} failed:\n"
                             f"{r.stderr[-3000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    return {tuple(int(v) for v in k.split("x")): v
            for k, v in res["ms"].items()}


def check_b2(dev, gen, parent=None) -> dict:
    """B2 at one image (``calculate_metrics``), at the training and
    serving batches and at ``B2_CHECK_SHAPES``: within
    1e-5 of the plain version, the same bits twice, one device kernel a
    call (``torch.profiler``); then, but for the last, L2-cold times from
    CUDA graph replays, twice, and the plain version's. With ``parent``
    (a checkout of an older commit) that commit's kernel is timed before
    and after, in processes of their own: its times are ``earlier_ms``."""
    earlier = [parent_b2_ms(parent)] if parent else []
    rows = {}
    for shape in B2_SHAPES + B2_CHECK_SHAPES:
        a = torch.rand(shape, generator=gen, device=dev)
        b = (a + 0.05 * torch.randn(shape, generator=gen,
                                    device=dev)).clamp(0, 1)
        got, want = ssim_per_sample(a, b), ssim_per_sample_plain(a, b)
        ok, err = within(got, want, 0.0, 1e-5)
        same = torch.equal(got, ssim_per_sample(a, b))
        names = device_kernels(lambda: ssim_per_sample(a, b))
        log("kernel_check", kernel="B2", shape=list(shape), dtype="fp32",
            max_abs_err=err, atol=1e-5, run_to_run_equal=same,
            device_kernels=names, ssim_first=float(got[0]), ok=ok)
        if not (ok and same and len(names) == 1):
            raise AssertionError(f"B2 at {shape}: max abs err {err} (gate "
                                 f"1e-5), run to run equal {same}, device "
                                 f"kernels a call {names}")
        if shape in B2_CHECK_SHAPES:
            continue
        pairs = l2_cold_copies(torch.stack([a, b]))
        runs = [cuda_ms_cold(lambda t: ssim_per_sample(t[0], t[1]), pairs)
                for _ in range(2)]
        p = cuda_ms_cold(lambda t: ssim_per_sample_plain(t[0], t[1]), pairs)
        del pairs
        k = sum(runs) / 2
        bnd, bound_by = b2_bound(shape)
        rows[shape] = {"ms": k, "plain_ms": p, "library_ms": None,
                       "bound_ms": bnd, "bound_by": bound_by,
                       "max_abs_err": err, "shape": list(shape),
                       "ms_runs": runs}
        if min(runs + [p]) < bnd:
            raise AssertionError(f"B2 times below their {bnd} ms bound at "
                                 f"{shape}: {runs}, {p}")
    if parent:
        earlier.append(parent_b2_ms(parent))
    for shape, r in rows.items():
        if earlier:
            r["earlier_runs"] = [e[shape] for e in earlier]
            r["earlier_ms"] = sum(r["earlier_runs"]) / len(earlier)
        log("kernel_time", kernel="B2", shape=r["shape"], kernel_ms=r["ms"],
            kernel_runs=r["ms_runs"], earlier_ms=r.get("earlier_ms"),
            earlier_runs=r.get("earlier_runs"), plain_ms=r["plain_ms"],
            library_ms=None, bound_ms=r["bound_ms"],
            bound_share=r["bound_ms"] / r["ms"],
            timing="L2-cold, CUDA graph replays; earlier: parent, this, "
                   "this, parent" if earlier else "L2-cold, CUDA graph "
                   "replays")
    # the row: the training batch; the serving batch beside it, one image
    # on its own row
    row = dict(rows[B2_ROW_SHAPE])
    row["batch16"] = rows[(16, 512, 512)]
    return {**row, "one_image": rows[(1, 512, 512)]}


def b4_sites(b: int, lr: int, f: int):
    """(site, (B, C, H, W), slope) of the int8 unet's 20 quantize sites:
    slope 0.2 where B4 applies the LeakyReLU a DoubleConv's first
    GroupNorm left owing, 1.0 elsewhere."""
    sites = []

    def dc(name, cin, cout, hw):
        sites.append((f"{name}.conv1", (b, cin, hw, hw), 1.0))
        sites.append((f"{name}.conv2", (b, cout, hw, hw), 0.2))

    dc("inc", 1, f, lr)
    for i in (1, 2, 3):
        dc(f"down{i}", f << (i - 1), f << i, lr >> i)
    for i in (1, 2, 3):
        cin, hw = f << (4 - i), lr >> (3 - i)
        sites.append((f"up{i}.up_conv", (b, cin, hw // 2, hw // 2), 1.0))
        dc(f"up{i}.conv", cin, cin // 2, hw)      # skip + cin/2 in
    sites.append(("final_up_conv", (b, f, 2 * lr, 2 * lr), 1.0))
    sites.append(("final_up_pixelshuffle.conv", (b, f, lr, lr), 1.0))
    sites.append(("final_conv1", (b, f // 2, 2 * lr, 2 * lr), 1.0))
    return sites


def zoo_quant_sites(family: str, b: int, lr: int, f: int):
    """``b4_sites`` of ``family``, in ``quant_forward.quant_sites``' order:
    unet_tpu's backbone is the unet's, its final stage quantizes the two
    branch convs' input and the head conv's (C = 2f); every edsr and
    simple site quantizes a ReLU's output (or the input) at slope 1.0."""
    if family == "unet":
        return b4_sites(b, lr, f)
    if family == "unet_tpu":
        return b4_sites(b, lr, f)[:-3] + [
            ("branch_a_conv", (b, f, lr, lr), 1.0),
            ("branch_b_conv", (b, f, lr, lr), 1.0),
            ("head_conv", (b, 2 * f, lr, lr), 1.0)]
    if family == "edsr":
        return [("head", (b, 1, lr, lr), 1.0)] + [
            (f"block{i}.conv{j}", (b, f, lr, lr), 1.0)
            for i in range(EDSR_BLOCKS) for j in (0, 1)] + [
            ("body_out", (b, f, lr, lr), 1.0)]
    return [("extract", (b, 1, lr, lr), 1.0), ("map", (b, f, lr, lr), 1.0)]


def other_sites(fused: bool):
    """(site, shape, slope) of every distinct B4 shape (``fused``: every
    ``gn_quantize`` shape) that the zoo phase quantizes at the serving
    and volume batches, and the extraction phase's unet one LR image of
    128^2 at a time, that the unet's sites at the serving batch do not
    hold, under the first family's site name that has it."""
    seen = {(shape, slope) for _, shape, slope in
            b4_sites(BATCH, LR, BASE_FILTERS)}
    out = []
    for b, lr, families in ((BATCH, LR, ZOO_FAMILIES),
                            (VOL_BATCH, VOL_HW, ZOO_FAMILIES),
                            (1, EXTRACT_TARGET // 2, ("unet",))):
        for family in families:
            for site, shape, slope in zoo_quant_sites(family, b, lr,
                                                      BASE_FILTERS):
                if (slope != 1.0) == fused and (shape, slope) not in seen:
                    seen.add((shape, slope))
                    out.append((f"{family} {site}", shape, slope))
    return out


# classes of per-channel scales of the exhaustive check: 1.0, amax /
# 127-like values, non-powers of two near both ends of [2^-64, 2^64] (the
# stream kernel's reciprocal route), and extremes outside it (its IEEE
# division)
EXHAUSTIVE_SCALES = (1.0, 0.0123, 3.7 / 127, 1e-30, 1e30, 1.0 / 3.0, 7.1e-20,
                     5.5e18)
# the stream kernel's elements a thread: the channels that share a route
STREAM_GROUP = 16


def every_bf16(c: int, dev, cls: int = 0) -> tuple:
    """(1, c, 256, 256) bf16 channels-last holding every finite bf16 code
    in every channel (rotated by the channel's index; 256 spare zeros),
    and (c,) scales that differ from channel to channel. Each group of 16
    channels (one stream thread's) takes one class of scale, class ``cls``
    for the first group and the next classes after it, so that a thread
    whose scales all lie in [2^-64, 2^64] runs the reciprocal route."""
    bits = (torch.arange(65536, dtype=torch.int32) << 16).view(torch.float32)
    col = torch.cat([bits[torch.isfinite(bits)], torch.zeros(256)])
    x = torch.stack([col.roll(17 * k) for k in range(c)], dim=1).to(
        torch.bfloat16).to(dev).view(1, 256, 256, c).permute(0, 3, 1, 2)
    n = len(EXHAUSTIVE_SCALES)
    s = torch.tensor([EXHAUSTIVE_SCALES[(k // STREAM_GROUP + cls) % n]
                      * (1 + k / 997) for k in range(c)], device=dev)
    return x, s


def reciprocal_groups(s: torch.Tensor) -> tuple:
    """(groups of 16 channels whose scales all lie in [2^-64, 2^64], all
    groups): the stream threads that take the reciprocal route, not the
    IEEE division (``csrc/quantize.cuh``, ``quant_fast_ok``)."""
    a = s.abs().cpu()
    ok = (a >= 2.0 ** -64) & (a <= 2.0 ** 64)
    groups = ok.view(-1, STREAM_GROUP) if s.numel() >= STREAM_GROUP \
        else ok.view(1, -1)
    return int(groups.all(dim=1).sum()), groups.shape[0]


def b4_bound(x: torch.Tensor) -> tuple:
    # one read of x (bf16) and the scales, one write of the codes; ~6 fp32
    # operations an element (compare, mul, div, round, 2 clamps)
    return bound_ms(3 * x.numel() + 4 * x.shape[1], 6.0 * x.numel(),
                    torch.float32)


def b4_site_check(site: str, shape, slope: float, dev, gen) -> tuple:
    """B4 at one int8 site on calibration-like scales: the stream route
    (through the wrapper) and the element kernel code for code against
    the plain version, the same codes twice; (x, scale)."""
    x = torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    # calibration-like scales (amax / 127), a little short so that some
    # codes saturate
    scale = (x.float().abs().amax(dim=(0, 2, 3)) / 140.0).contiguous()
    want = leaky_quantize_plain(x, scale, slope)
    before = leaky_quantize.stream_launches
    got = leaky_quantize(x, scale, slope)
    stream = leaky_quantize.stream_launches == before + 1
    same = torch.equal(got, leaky_quantize(x, scale, slope))
    ok = torch.equal(got, want) and stream and \
        torch.equal(leaky_quantize_generic(x, scale, slope), want)
    log("kernel_check", kernel="B4", site=site, shape=list(shape),
        slope=slope, dtype="bf16->s8", routes=["stream", "element"],
        exact=ok, run_to_run_equal=same,
        saturated=int((got.abs() == 127).sum()))
    if not (ok and same):
        raise AssertionError(f"B4 disagrees with its plain version at "
                             f"{site} {shape} (stream route taken: "
                             f"{stream}) or from run to run ({same})")
    return x, scale


def check_b4(dev, gen) -> dict:
    """B4's stream route and the element kernel it replaces: code for code
    against the plain version on every finite bf16 code (C = 1 and 16 with
    each class of scale alone, so that every in-range class runs the
    stream kernel's reciprocal route on every code; C = 256 with all
    classes at once), at the 20 unet sites and at the zoo's and the
    extraction phase's other shapes (``other_sites``), then both L2-cold
    at every unet site. The row reports the 13 sites the stream route serves on the int8
    path (the element kernel's sum there is its earlier_ms), and the sums
    over all 20 beside them."""
    n = len(EXHAUSTIVE_SCALES)
    cases = [(c, cls) for c in (1, 16) for cls in range(n)] + [(256, 0)]
    for c, cls in cases:
        x, s = every_bf16(c, dev, cls)
        fast, groups = reciprocal_groups(s)
        for slope in (0.2, 1.0):
            want = leaky_quantize_plain(x, s, slope)
            before = leaky_quantize.stream_launches
            got = leaky_quantize(x, s, slope)
            stream = leaky_quantize.stream_launches == before + 1
            same = torch.equal(got, leaky_quantize(x, s, slope))
            ok = torch.equal(got, want) and stream and torch.equal(
                leaky_quantize_generic(x, s, slope), want)
            log("kernel_check", kernel="B4", check="every finite bf16 code",
                shape=list(x.shape), slope=slope, scale_class=cls,
                first_scale=float(s[0]), reciprocal_groups=fast,
                groups=groups, routes=["stream", "element"], exact=ok,
                run_to_run_equal=same)
            if not (ok and same):
                raise AssertionError(f"B4 disagrees with its plain version on "
                                     f"the bf16 codes at C = {c}, scale class "
                                     f"{cls}, slope {slope} (stream route "
                                     f"taken: {stream})")
        del x, want, got
    keys = ("ms", "earlier_ms", "plain_ms", "bound_ms")
    tot, fused, standalone = (dict.fromkeys(keys, 0.0) for _ in range(3))
    bound_by, elems = "bytes", 0
    # the zoo's and the extraction phase's own shapes, checked and not
    # timed
    for site, shape, slope in other_sites(fused=False):
        b4_site_check(site, shape, slope, dev, gen)
    for site, shape, slope in b4_sites(BATCH, LR, BASE_FILTERS):
        x, scale = b4_site_check(site, shape, slope, dev, gen)
        xs = l2_cold_copies(x)
        k = cuda_ms_cold(lambda t: leaky_quantize(t, scale, slope), xs)
        e = cuda_ms_cold(lambda t: leaky_quantize_generic(t, scale, slope),
                         xs)
        p = cuda_ms_cold(lambda t: leaky_quantize_plain(t, scale, slope), xs)
        del xs
        bnd, bound_by = b4_bound(x)
        log("kernel_time", kernel="B4", site=site, shape=list(shape),
            kernel_ms=k, element_ms=e, plain_ms=p, library_ms=None,
            bound_ms=bnd, bound_share=bnd / k, element_bound_share=bnd / e,
            timing="L2-cold, CUDA graph replays")
        if min(k, e, p) < bnd:
            raise AssertionError(f"B4 times below their {bnd} ms bound at "
                                 f"{site}: {k}, {e}, {p}")
        part = fused if slope != 1.0 else standalone
        for key, v in zip(keys, (k, e, p, bnd)):
            tot[key] += v
            part[key] += v
        elems += x.numel()
        del x
    log("kernel_total", kernel="B4", sites=20, elements=elems, **tot,
        bound_share=tot["bound_ms"] / tot["ms"],
        standalone_13=standalone, conv2_7=fused,
        note="ms: stream route; earlier_ms: element kernel")
    # the row: the 13 sites B4 serves on the int8 path (the seven conv2
    # sites run in gn_quantize's row)
    return {**standalone, "library_ms": None, "max_abs_err": 0.0,
            "bound_by": bound_by, "sites": 13, "all_20_sites": tot}


def fused_site_check(site: str, shape, slope: float, dev, gen) -> tuple:
    """``gn_quantize`` at one conv2 site: one fused launch, code for code
    against B1 at slope 1.0 followed by the plain B4, the same codes
    twice, and within one code on under 0.5% of the elements of its own
    plain version (the GroupNorm in fp32 in PyTorch, whose bf16 output may
    differ from B1's by one ulp); (x, gamma, beta, scales)."""
    x = torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    c = shape[1]
    g = torch.randn(c, generator=gen, device=dev)
    b = torch.randn(c, generator=gen, device=dev)
    y = group_norm_leaky(x, g, b, negative_slope=1.0)
    s = (y.float().abs().amax(dim=(0, 2, 3)) / 140.0).contiguous()
    want = leaky_quantize_plain(y, s, slope)
    before = gn_quantize.launches
    got = gn_quantize(x, g, b, s, slope)
    ok = torch.equal(got, want) and gn_quantize.launches == before + 1
    same = torch.equal(got, gn_quantize(x, g, b, s, slope))
    d = (got.short() - gn_quantize_plain(x, g, b, s, slope).short()).abs()
    d_max, d_frac = int(d.max()), float((d != 0).float().mean())
    close = d_max <= CODES_MAX_DIFF and d_frac < CODES_MAX_FRAC
    log("kernel_check", kernel="B4 fused", site=site, shape=list(shape),
        slope=slope, dtype="bf16->s8", exact_vs_b1_plus_b4=ok,
        run_to_run_equal=same, vs_plain_max_code_diff=d_max,
        vs_plain_frac_differing=d_frac, vs_plain_close=close,
        bound=f"codes within {CODES_MAX_DIFF} on under "
              f"{CODES_MAX_FRAC:.1%} of elements",
        saturated=int((got.abs() == 127).sum()))
    if not (ok and same and close):
        raise AssertionError(f"gn_quantize disagrees with B1 + B4 at "
                             f"{site} {shape} ({ok}), from run to run "
                             f"({same}) or with its plain version (codes "
                             f"up to {d_max} apart on {d_frac:.3%})")
    return x, g, b, s


def check_fused(dev, gen) -> dict:
    """B4's fused route (gn_quantize: B1's one-pass kernel with an int8
    output) at the seven DoubleConv conv2 sites, at the serving batch, at
    unet_tpu's volume batch and at the extraction phase's one image
    (``fused_site_check``); then, at the
    serving batch, L2-cold against B1 (bf16 out) + B4 run separately
    (earlier_ms)."""
    keys = ("ms", "earlier_ms", "b1_bf16_ms", "plain_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    bound_by = "bytes"
    # the zoo's and the extraction phase's own shapes (unet_tpu's conv2
    # sites at the volume batch, the unet's at one image of 128^2),
    # checked and not timed
    for site, shape, slope in other_sites(fused=True):
        fused_site_check(site, shape, slope, dev, gen)
    for site, shape, slope in b4_sites(BATCH, LR, BASE_FILTERS):
        if slope == 1.0:
            continue
        x, g, b, s = fused_site_check(site, shape, slope, dev, gen)
        c = shape[1]
        xs = l2_cold_copies(x)
        k = cuda_ms_cold(lambda t: gn_quantize(t, g, b, s, slope), xs)
        two = cuda_ms_cold(lambda t: leaky_quantize(
            group_norm_leaky(t, g, b, negative_slope=1.0), s, slope), xs)
        b1 = cuda_ms_cold(
            lambda t: group_norm_leaky(t, g, b, negative_slope=1.0), xs)
        p = cuda_ms_cold(lambda t: gn_quantize_plain(t, g, b, s, slope), xs)
        del xs
        # one read of x (bf16), one write of the codes, the (C,) gamma,
        # beta and scales; ~16 fp32 operations an element (statistics,
        # affine, LeakyReLU, quantize)
        bnd, bound_by = bound_ms(3 * x.numel() + 12 * c, 16.0 * x.numel(),
                                 torch.float32)
        log("kernel_time", kernel="B4 fused", site=site, shape=list(shape),
            kernel_ms=k, b1_plus_b4_ms=two, b1_bf16_ms=b1, plain_ms=p,
            library_ms=None, bound_ms=bnd, bound_share=bnd / k,
            timing="L2-cold, CUDA graph replays")
        if min(k, two, b1, p) < bnd:
            raise AssertionError(f"fused B4 times below their {bnd} ms bound "
                                 f"at {site}: {k}, {two}, {b1}, {p}")
        for key, v in zip(keys, (k, two, b1, p, bnd)):
            tot[key] += v
        del x
    log("kernel_total", kernel="B4 fused", sites=7, **tot,
        bound_share=tot["bound_ms"] / tot["ms"],
        note="earlier_ms: B1 bf16 out + B4 stream, run separately")
    return {**tot, "library_ms": None, "max_abs_err": 0.0,
            "bound_by": bound_by}


def b1_bwd_bound(x: torch.Tensor) -> tuple:
    # one read of x and g, one write of dx (x's dtype); ~20 fp32 operations
    # an element (statistics, xhat, z, the mask, the four sums, dx)
    return bound_ms(3 * x.numel() * x.element_size(), 20.0 * x.numel(),
                    torch.float32)


def _b1_bwd_gates(got, want) -> tuple:
    """B1 backward's gates against the twin: dx within one bf16 ulp
    (relative) plus 1e-5, dscale and dbias within rtol 1e-4 plus 1e-4 of
    their largest entry (sums of ~1e6 terms of either sign). (ok, max abs
    errors of dx, dscale, dbias)."""
    ok_dx, err = within(got[0], want[0], BF16_RTOL, 1e-5)
    ok_s, err_s = within(got[1], want[1], 1e-4,
                         1e-4 * float(want[1].abs().max()))
    ok_b, err_b = within(got[2], want[2], 1e-4,
                         1e-4 * float(want[2].abs().max()))
    return ok_dx and ok_s and ok_b, err, err_s, err_b


def _bwd_inputs(shape, dev, gen, offset=0):
    """x and g of one shape as two halves of one channels-last buffer
    (``offset`` elements into it breaks 16-byte alignment), and seeded
    gamma, beta."""
    b, c, h, w = shape
    buf = torch.randn(2 * b * c * h * w + offset, generator=gen, device=dev)
    xg = buf.to(torch.bfloat16)[offset:].view(2 * b, h, w, c).permute(
        0, 3, 1, 2)
    gam = torch.randn(c, generator=gen, device=dev)
    bet = torch.randn(c, generator=gen, device=dev)
    return xg, gam, bet


def _b1_bwd_times(xg, gam, bet, b: int, dev) -> tuple:
    """L2-cold times (CUDA graph replays) of B1's backward through the
    wrapper, of its four-pass kernel, of the plain twin and of the
    library's backward, at x = xg[:b], g = xg[b:]."""
    xs = l2_cold_copies(xg)
    k = cuda_ms_cold(lambda t: group_norm_leaky_backward(
        t[:b], gam, bet, t[b:]), xs)
    four = cuda_ms_cold(lambda t: group_norm_leaky_backward_fourpass(
        t[:b], gam, bet, t[b:]), xs)
    p = cuda_ms_cold(lambda t: group_norm_leaky_backward_plain(
        t[:b], gam, bet, t[b:]), xs)
    # the forwards on a stream of their own, where autograd then runs
    # their backwards and the graph captures them
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graphs = []
    with torch.cuda.stream(side):
        for t in xs:
            xi = t[:b].detach().requires_grad_()
            gi = gam.to(torch.bfloat16).requires_grad_()
            bi = bet.to(torch.bfloat16).requires_grad_()
            graphs.append((F.leaky_relu(F.group_norm(xi, 8, gi, bi), 0.2),
                           (xi, gi, bi), t[b:]))
    torch.cuda.synchronize(dev)
    lib = cuda_ms_cold(lambda e: torch.autograd.grad(
        e[0], e[1], e[2], retain_graph=True), graphs, stream=side)
    return k, four, p, lib


def check_b1_backward(dev, gen) -> dict:
    """B1's backward at the unet's 20 training sites (batch 8 of 128^2,
    base filters 32, bf16): the one-pass route the wrapper takes there and
    the four-pass kernel against the plain twin (``_b1_bwd_gates``), the
    same bits twice, the device kernels a call (``torch.profiler``); the
    one-pass route replayed twice from a CUDA graph captured on a side
    stream, with the eager call's bits; the four-pass kernel at a shape of
    its own route (an offset view). Then L2-cold times of both routes, the
    twin and the library's backward (``torch.autograd.grad`` of
    ``F.leaky_relu(F.group_norm(x, 8, g, b), 0.2)`` with respect to (x, g,
    b), its forward graph built beforehand), from CUDA graph replays."""
    keys = ("ms", "earlier_ms", "plain_ms", "library_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    worst, bound_by = 0.0, "bytes"
    kernels_a_call = {}
    for shape, count in gn_sites(TRAIN_BATCH, TRAIN_LR, BASE_FILTERS):
        b = shape[0]
        xg, gam, bet = _bwd_inputs(shape, dev, gen)
        x, gy = xg[:b], xg[b:]
        plan = onepass_backward_plan(x, gy, torch.empty_like(x))
        if plan is None:
            raise AssertionError(f"B1's one-pass backward does not take "
                                 f"{shape}")
        want = group_norm_leaky_backward_plain(x, gam, bet, gy)
        for route, fn in (("onepass", group_norm_leaky_backward),
                          ("fourpass", group_norm_leaky_backward_fourpass)):
            before = group_norm_leaky_backward.onepass_launches
            got = fn(x, gam, bet, gy)
            onepass = group_norm_leaky_backward.onepass_launches - before
            ok, err, err_s, err_b = _b1_bwd_gates(got, want)
            again = fn(x, gam, bet, gy)
            same = all(torch.equal(u, v) for u, v in zip(got, again))
            names = device_kernels(lambda: fn(x, gam, bet, gy))
            kernels_a_call[route] = len(names)
            log("kernel_check", kernel="B1 backward", route=route,
                shape=list(shape), dtype="bf16", plan=plan._asdict(),
                max_abs_err_dx=err, max_abs_err_dscale=err_s,
                max_abs_err_dbias=err_b, gates="dx rtol 2^-7 atol 1e-5; "
                "dscale, dbias rtol 1e-4 atol 1e-4 of the largest entry",
                run_to_run_equal=same, device_kernels=names,
                onepass_launches=onepass, ok=ok)
            want_onepass = 1 if route == "onepass" else 0
            if not (ok and same and onepass == want_onepass):
                raise AssertionError(f"B1's backward ({route}) disagrees with "
                                     f"its plain twin at {shape} (dx {err}, "
                                     f"dscale {err_s}, dbias {err_b}), from "
                                     f"run to run ({same}) or took the "
                                     f"wrong route ({onepass} one-pass "
                                     f"launches)")
            if route == "onepass":
                worst = max(worst, err)
                if len(names) != 1:
                    raise AssertionError(f"the one-pass backward ran "
                                         f"{names} at {shape}")
        del got, want, again
        k, four, p, lib = _b1_bwd_times(xg, gam, bet, b, dev)
        bnd, bound_by = b1_bwd_bound(x)
        log("kernel_time", kernel="B1 backward", shape=list(shape),
            sites=count, kernel_ms=k, fourpass_ms=four, plain_ms=p,
            library_ms=lib, bound_ms=bnd, bound_share=bnd / k,
            fourpass_bound_share=bnd / four,
            timing="L2-cold, CUDA graph replays")
        if min(k, four, p, lib) < bnd:
            raise AssertionError(f"B1 backward times below their {bnd} ms "
                                 f"bound at {shape}: {k}, {four}, {p}, {lib}")
        for key, v in zip(keys, (k, four, p, lib, bnd)):
            tot[key] += count * v
    log("kernel_total", kernel="B1 backward", sites=20, **tot,
        bound_share=tot["bound_ms"] / tot["ms"],
        device_kernels_a_call=kernels_a_call,
        note="ms: one-pass route; earlier_ms: four-pass kernel")
    check_b1_backward_graph(dev, gen)
    check_b1_backward_fourpass_route(dev, gen)
    return {**tot, "max_abs_err": worst, "bound_by": bound_by,
            "device_kernels_a_call": kernels_a_call}


def check_b1_backward_sites(dev, gen, n: int, lr: int,
                            served_by: str) -> dict:
    """B1's backward through its wrapper at the unet's 20 sites of a batch
    of ``n`` LR images of ``lr``^2 (bf16), whatever route the wrapper
    takes there, against the plain twin (``_b1_bwd_gates``) and run to
    run, not timed; the one-pass launches by shape."""
    onepass = {}
    for shape, _ in gn_sites(n, lr, BASE_FILTERS):
        xg, gam, bet = _bwd_inputs(shape, dev, gen)
        x, gy = xg[:n], xg[n:]
        want = group_norm_leaky_backward_plain(x, gam, bet, gy)
        before = group_norm_leaky_backward.onepass_launches
        got = group_norm_leaky_backward(x, gam, bet, gy)
        onepass[str(list(shape))] = \
            group_norm_leaky_backward.onepass_launches - before
        ok, err, err_s, err_b = _b1_bwd_gates(got, want)
        same = all(torch.equal(u, v) for u, v in zip(
            got, group_norm_leaky_backward(x, gam, bet, gy)))
        log("kernel_check", kernel="B1 backward", route="wrapper",
            shape=list(shape), served_by=served_by, dtype="bf16",
            onepass=bool(onepass[str(list(shape))]), max_abs_err_dx=err,
            max_abs_err_dscale=err_s, max_abs_err_dbias=err_b,
            run_to_run_equal=same, ok=ok)
        if not (ok and same):
            raise AssertionError(f"B1's backward disagrees with its plain "
                                 f"twin at {shape} ({served_by}: dx {err}, "
                                 f"dscale {err_s}, dbias {err_b}) or from "
                                 f"run to run ({same})")
        del xg, x, gy, got, want
    return onepass


def check_b1_backward_graph(dev, gen) -> None:
    """The one-pass backward at the two-wave training site captured in a
    CUDA graph on a side stream: two replays give the eager call's bits,
    so its counters are back at zero after every launch."""
    shape = gn_sites(TRAIN_BATCH, TRAIN_LR, BASE_FILTERS)[-1][0]
    b = shape[0]
    xg, gam, bet = _bwd_inputs(shape, dev, gen)
    x, gy = xg[:b], xg[b:]
    eager = group_norm_leaky_backward(x, gam, bet, gy)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = group_norm_leaky_backward(x, gam, bet, gy)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize(dev)
        replays.append(all(torch.equal(u, v) for u, v in zip(out, eager)))
    log("kernel_check", kernel="B1 backward", route="onepass",
        check="CUDA graph captured on a side stream", shape=list(shape),
        replays_equal_eager=replays)
    if not all(replays):
        raise AssertionError(f"B1's one-pass backward in a CUDA graph at "
                             f"{shape}: replays equal to the eager call "
                             f"{replays}")


def check_b1_backward_fourpass_route(dev, gen) -> None:
    """The four-pass kernel on a shape of its own route (an offset view,
    not 16-byte aligned) through the wrapper, against the twin."""
    shape = (2, 16, 64, 64)
    xg, gam, bet = _bwd_inputs(shape, dev, gen, offset=1)
    x, gy = xg[:2], xg[2:]
    before = group_norm_leaky_backward.onepass_launches
    if onepass_backward_plan(x, gy, torch.empty_like(x)) is not None:
        raise AssertionError("an offset view took the one-pass backward")
    got = group_norm_leaky_backward(x, gam, bet, gy)
    ok, err, err_s, err_b = _b1_bwd_gates(
        got, group_norm_leaky_backward_plain(x, gam, bet, gy))
    fourpass = group_norm_leaky_backward.onepass_launches == before
    log("kernel_check", kernel="B1 backward", route="fourpass",
        check="offset view", shape=list(shape), max_abs_err_dx=err,
        max_abs_err_dscale=err_s, max_abs_err_dbias=err_b,
        took_fourpass=fourpass, ok=ok)
    if not (ok and fourpass):
        raise AssertionError(f"B1's four-pass backward at an offset view: "
                             f"dx {err}, dscale {err_s}, dbias {err_b}, "
                             f"four-pass route {fourpass}")


def main_path(dev, cfg, params, lr, hr):
    # the serving path's peak, not the kernel phases' timing buffers
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(cfg, params, bf16=True, device=dev)
    engine.upscale_batch(lr[:2])                    # load the library, warm

    kernels.reset_launch_counts()
    out = engine.upscale_batch(lr)
    metrics = engine.calculate_metrics(out[0], hr[0], dev)
    counts = kernels.launch_counts()
    onepass = group_norm_leaky.onepass_launches
    log("main_path", slices=BATCH, input=[LR, LR], output=list(out.shape[1:]),
        params=param_count(engine.model), launches=counts,
        onepass_launches=onepass, metrics=metrics)
    if out.shape != (BATCH, 2 * LR, 2 * LR) or not np.isfinite(out).all() \
            or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"bad output: shape {out.shape}, range "
                             f"[{out.min()}, {out.max()}]")
    want = dict.fromkeys(counts, 0)
    want.update(group_norm_leaky=20, conv3x3=2, ssim_per_sample=1)
    if counts != want or onepass != 20:
        raise AssertionError(f"launch counts {counts} (B1 one-pass "
                             f"{onepass}), expected {want} (20)")

    # end-to-end serving rate: host batch in, host batch out
    iters = 10
    ms = cuda_ms(lambda: engine.upscale_batch(lr), iters=iters, warmup=2)
    fwd_ms = cuda_ms(lambda: engine._dispatch_once(lr), iters=iters,
                     warmup=2)
    log("throughput", batch=BATCH, ms_per_batch=ms,
        slices_per_s=BATCH / ms * 1e3, forward_ms_per_batch=fwd_ms,
        forward_slices_per_s=BATCH / fwd_ms * 1e3,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # the CPU port on 2 of the slices, held to the bf16 budget
    cpu = InferenceEngine(cfg, params, bf16=True, device="cpu")
    out_cpu = cpu.upscale_batch(lr[:2])
    gt = torch.from_numpy(hr[:2, :, :, None])
    g, c = torch.from_numpy(out[:2, :, :, None]), torch.from_numpy(
        out_cpu[:, :, :, None])
    d_psnr = abs(float(psnr(g, gt)) - float(psnr(c, gt)))
    d_ssim = abs(float(ssim(g, gt)) - float(ssim(c, gt)))
    ok = d_psnr <= 0.1 and d_ssim <= 1e-3
    log("cpu_vs_gpu", slices=2, d_psnr_db=d_psnr, d_ssim=d_ssim,
        psnr_gpu_vs_cpu=float(psnr(g, c)),
        max_abs_diff=float(np.abs(out[:2] - out_cpu).max()), ok=ok)
    if not ok:
        raise AssertionError("GPU and CPU ports differ beyond the bf16 "
                             "budget")
    return counts, engine


def _write_volume(path: Path, seed: int) -> np.ndarray:
    """A (256, 256, 96) phantom volume stored as int16 with scl_slope 0.5
    (physical values up to 1000), written by the port's codec; returns
    the (96, 512, 512) 2x ground truth."""
    lr = phantom_batch(np.random.default_rng(seed), VOL_SLICES, VOL_HW)
    stored = np.round(lr * 2000.0).astype(np.int16)
    nifti.save(str(path), np.transpose(stored, (1, 2, 0)),
               zooms=(1.0, 1.0, 3.0), scl_slope=VOL_SLOPE)
    return phantom_batch(np.random.default_rng(seed), VOL_SLICES, 2 * VOL_HW)


def _budget_quiet(got: dict, want: dict) -> dict:
    """The bf16 budget between two results against one truth."""
    d = {"d_psnr_db": abs(got["psnr_db"] - want["psnr_db"]),
         "d_ssim": abs(got["ssim"] - want["ssim"])}
    d["ok"] = bool(d["d_psnr_db"] <= 0.1 and d["d_ssim"] <= 1e-3)
    return d


def _budget(name: str, got: dict, want: dict) -> dict:
    """:func:`_budget_quiet`, logged; raises beyond the budget."""
    d = _budget_quiet(got, want)
    log("volume_check", check=name, got=got, want=want, **d)
    if not d["ok"]:
        raise AssertionError(f"{name}: beyond the bf16 budget ({d})")
    return d


def _serve_volume(argv) -> dict:
    """One in-process run of the infer_volume CLI with the launch counts
    set to 0 just before and read just after; its wall time and peak
    device memory."""
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = volume_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"rc": rc, "seconds": seconds,
            "launches": {k: v for k, v in kernels.launch_counts().items()
                         if v},
            "onepass_launches": group_norm_leaky.onepass_launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _read_volume(path: Path, slope: float) -> np.ndarray:
    """An output volume as (96, 512, 512) [0, 1] slices, after checking
    its shape, zooms and scl_slope."""
    data, hdr = nifti.load(str(path), raw=True)
    zooms_ok = np.allclose(hdr.zooms, (0.5, 0.5, 3.0))
    if data.shape != (2 * VOL_HW, 2 * VOL_HW, VOL_SLICES) or not zooms_ok \
            or not math.isclose(hdr.scl_slope, slope, rel_tol=1e-6):
        raise AssertionError(f"{path}: shape {data.shape}, zooms "
                             f"{hdr.zooms}, scl_slope {hdr.scl_slope}")
    out = np.transpose(data, (2, 0, 1)).astype(np.float32) * np.float32(
        hdr.scl_slope)
    if not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"{path}: values outside [0, 1]")
    return out


def volume_path(dev, cfg, params) -> dict:
    """Whole-volume serving through its entry point, the infer_volume CLI
    (in this process, on the card, at batch 32): (a) the defaults, (b)
    ``--serve_raw --out_dtype int16`` (``transpose_io``), (c) ``--tta``,
    (d) a directory of two volumes; each run's launches (B1 20 and B3 2 a
    batch, 160 and 16 under TTA, B1 all one-pass); the outputs against
    each other and against the CPU port at the bf16 budget; one 600^2
    slice through ``upscale_tiled``; then the window against the
    sequential loop, (a) against (b), and (c), by CUDA events."""
    shutil.rmtree(VOL_DIR, ignore_errors=True)
    for sub in ("dir", "ckpt"):
        (VOL_DIR / sub).mkdir(parents=True)
    ckpt.save_checkpoint(str(VOL_DIR / "ckpt" / "best_model_unet"), params,
                         meta={"config": {"model": {
                             "model_type": "unet",
                             "base_filters": BASE_FILTERS}}})
    vol = VOL_DIR / "vol.nii"
    truth = _write_volume(vol, seed=VOL_SEED)
    for name in ("vol_a.nii", "vol_b.nii"):
        shutil.copy(vol, VOL_DIR / "dir" / name)
    common = ["--checkpoint_dir", str(VOL_DIR / "ckpt"),
              "--batch_size", str(VOL_BATCH)]
    batches = -(-VOL_SLICES // VOL_BATCH)
    runs = {"a": ([], 1, 1.0),
            "b": (["--serve_raw", "--out_dtype", "int16"], 1, 1 / 32767),
            "c": (["--tta"], 8, 1.0),
            "d": ([], 1, 1.0)}
    res, outs = {}, {}
    for key, (flags, members, slope) in runs.items():
        src, dst = ((VOL_DIR / "dir", VOL_DIR / "dir_sr") if key == "d"
                    else (vol, VOL_DIR / f"sr_{key}.nii"))
        r = _serve_volume(["--input", str(src), "--output", str(dst),
                           *common, *flags])
        n_vol = 2 if key == "d" else 1
        want = {"group_norm_leaky": 20 * members * batches * n_vol,
                "conv3x3": 2 * members * batches * n_vol}
        r["volumes"] = n_vol
        r["launches_ok"] = (r["launches"] == want and
                            r["onepass_launches"] == want["group_norm_leaky"])
        res[key] = r
        log("volume_path", run=key, flags=flags, batches=batches * n_vol,
            expected_launches=want, **r)
        if r["rc"] != 0 or not r["launches_ok"]:
            raise AssertionError(f"volume run {key}: exit {r['rc']}, "
                                 f"launches {r['launches']} (one-pass "
                                 f"{r['onepass_launches']}), expected "
                                 f"{want}")
        if key == "d":
            outs[key] = [_read_volume(dst / f"vol_{v}_sr.nii", slope)
                         for v in "ab"]
        else:
            outs[key] = _read_volume(dst, slope)

    q = {k: _quality(outs[k], truth, dev) for k in "abc"}
    _budget("serve_raw int16 (b) against defaults (a)", q["b"], q["a"])
    for i, o in enumerate(outs["d"]):
        _budget(f"directory volume {i} (d) against (a)",
                _quality(o, truth, dev), q["a"])

    # two slices of (a) and (c) against the CPU port on the same slices
    stack, norm = _volume_slices(vol)
    gt = truth[VOL_CPU_SLICES]
    for key, kw in (("a", {}), ("c", {"tta": True})):
        cpu = InferenceEngine(cfg, params, bf16=True, device="cpu", **kw)
        _budget(f"({key}) slices {VOL_CPU_SLICES.start}-"
                f"{VOL_CPU_SLICES.stop - 1} against the CPU port",
                _quality(outs[key][VOL_CPU_SLICES], gt, dev),
                _quality(cpu.upscale_batch(norm), gt, dev))

    # one 600^2 slice through upscale_tiled (9 tiles of 256^2, one batch)
    big = phantom_batch(np.random.default_rng(4), 1, TILED_HW)[0]
    big_gt = phantom_batch(np.random.default_rng(4), 1, 2 * TILED_HW)
    engine = InferenceEngine(cfg, params, bf16=True, device=dev)
    kernels.reset_launch_counts()
    tiled = engine.upscale_tiled(big, tile=TILE, halo=HALO)
    tiled_counts = {k: v for k, v in kernels.launch_counts().items() if v}
    if tiled.shape != (2 * TILED_HW, 2 * TILED_HW):
        raise AssertionError(f"upscale_tiled gave {tiled.shape}")
    cpu = InferenceEngine(cfg, params, bf16=True, device="cpu")
    log("volume_tiled", input=[TILED_HW, TILED_HW], tile=TILE,
        output=list(tiled.shape), launches=tiled_counts)
    if tiled_counts != {"group_norm_leaky": 20, "conv3x3": 2}:
        raise AssertionError(f"upscale_tiled launches {tiled_counts}: its "
                             "tiles are one batch, one forward")
    _budget(f"upscale_tiled {TILED_HW}^2 against the CPU port",
            _quality(tiled[None], big_gt, dev),
            _quality(cpu.upscale_tiled(big, tile=TILE, halo=HALO)[None],
                     big_gt, dev))

    # the CLI's inputs: (a) the stack normalized on the card and fetched
    # into page-locked memory, (b) the raw volume's buffer, page-locked
    # for the rest of the phase
    norm_all = volume_cli._normalize_stack(stack, dev)
    raw, _ = nifti.load(str(vol), raw=True)
    eng_b = InferenceEngine(cfg, params, bf16=True, device=dev,
                            normalize_inputs=True, transpose_io=True,
                            out_dtype="int16")
    # the page-lock of a freshly read volume and its release, timed
    # before the phase's own volume is locked (two locked buffers may
    # share a page)
    lock_ms = []
    for _ in range(3):
        fresh, _ = nifti.load(str(vol), raw=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with eng_b.page_locked(fresh.T):
            pass
        lock_ms.append((time.perf_counter() - t0) * 1e3)
    with eng_b.page_locked(raw.T) as raw_locked:
        _volume_times(dev, cfg, params, stack, vol, res, engine, eng_b,
                      norm_all, raw_locked, sorted(lock_ms)[1])
    return res["a"]["launches"]


def _volume_times(dev, cfg, params, stack, vol, res, engine, eng_b,
                  norm_all, raw_locked, page_lock_ms) -> None:
    """Where a volume's time goes, and the window against the sequential
    loop, on the CLI's page-locked inputs (``norm_all`` for run a,
    ``raw_locked``, the (n, w, h) view of the raw volume, for run b)."""
    starts = range(0, VOL_SLICES, VOL_BATCH)
    plain = [norm_all[s:s + VOL_BATCH] for s in starts]
    raw_t = [raw_locked[s:s + VOL_BATCH] for s in starts]
    if not all(torch.from_numpy(b).is_pinned() for b in plain + raw_t):
        raise AssertionError("the CLI's batches are not page-locked")

    def host_ms(fn):
        t = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append((time.perf_counter() - t0) * 1e3)
        return sorted(t)[1]

    def read_a():
        d, _ = nifti.load(str(vol))
        return np.ascontiguousarray(np.transpose(d, (2, 0, 1))).astype(
            np.float32)

    def staged_upload(bs):
        # what a caller with pageable batches gets: a page-locked copy
        paged = [np.array(b) for b in bs]
        return lambda: [engine._upload(b) for b in paged]

    def fetch_ms(eng, bs):
        ys = [eng._dispatch_once(b)[0] for b in bs]   # one device
        torch.cuda.synchronize()
        return host_ms(lambda: [eng._collect(eng._start_fetch(y))
                                for y in ys])

    out_a = np.concatenate([engine.upscale_batch(b) for b in plain])
    out_b = np.concatenate([eng_b.upscale_batch(b) for b in raw_t])
    stages = {
        "a": {"read_ms": host_ms(read_a),
              "normalize_round_trip_ms": host_ms(
                  lambda: volume_cli._normalize_stack(stack, dev)),
              "upload_ms": host_ms(lambda: [engine._upload(b)
                                            for b in plain]),
              "staged_upload_ms": host_ms(staged_upload(plain)),
              "upload_forward_ms": host_ms(lambda: [
                  engine._dispatch_once(b) for b in plain]),
              "fetch_ms": fetch_ms(engine, plain),
              "write_ms": host_ms(lambda: nifti.save(
                  str(VOL_DIR / "stage_a.nii"),
                  np.transpose(out_a, (1, 2, 0))))},
        "b": {"read_ms": host_ms(lambda: nifti.load(str(vol), raw=True)),
              "page_lock_ms": page_lock_ms,
              "upload_ms": host_ms(lambda: [eng_b._upload(b)
                                            for b in raw_t]),
              "staged_upload_ms": host_ms(staged_upload(raw_t)),
              "upload_normalize_forward_ms": host_ms(lambda: [
                  eng_b._dispatch_once(b) for b in raw_t]),
              "fetch_ms": fetch_ms(eng_b, raw_t),
              "write_ms": host_ms(lambda: nifti.save(
                  str(VOL_DIR / "stage_b.nii"), out_b.T))}}
    log("volume_breakdown", slices=VOL_SLICES, batch=VOL_BATCH,
        stages=stages, cli_seconds={k: res[k]["seconds"] for k in "ab"},
        timing="host clock around work ending in a synchronize, median "
               "of 3; upload_ms from the CLI's page-locked stack (a) or "
               "volume buffer (b), staged_upload_ms from pageable copies "
               "of the same batches, page_lock_ms the register and "
               "unregister of the raw volume; "
               "upload_forward_ms is _dispatch_once (upload, forward, "
               "crop, pack), fetch_ms the copies of its results to "
               "page-locked host memory")

    # rates: window against the sequential loop, in turns, by CUDA events
    # around whole passes over the volume (upload, forward, fetch)
    engines = {
        "a": (engine, plain),
        "b": (eng_b, raw_t),
        "c": (InferenceEngine(cfg, params, bf16=True, device=dev, tta=True),
              plain)}

    def window(eng, bs):
        return lambda: list(eng.upscale_batches(bs))

    def sequential(eng, bs):
        return lambda: [eng.upscale_batch(b) for b in bs]

    ms = {"window": [], "sequential": []}
    eng_a, bs_a = engines["a"]
    for name in ("sequential", "window", "window", "sequential"):
        fn = (window if name == "window" else sequential)(eng_a, bs_a)
        ms[name].append(cuda_ms(fn, iters=3, warmup=1))
    rates = {k: VOL_SLICES / (sum(v) / len(v)) * 1e3 for k, v in ms.items()}
    torch.cuda.reset_peak_memory_stats()
    paths = {k: cuda_ms(window(eng, bs), iters=3, warmup=1)
             for k, (eng, bs) in engines.items()}
    log("volume_throughput", slices=VOL_SLICES, batch=VOL_BATCH,
        ms_per_volume=ms, slices_per_s=rates,
        window_over_sequential=rates["window"] / rates["sequential"],
        window_ms_per_volume_by_run=paths,
        window_slices_per_s_by_run={k: VOL_SLICES / v * 1e3
                                    for k, v in paths.items()},
        cli_seconds_per_volume={k: r["seconds"] / r["volumes"]
                                for k, r in res.items()},
        cli_peak_mem_gb={k: r["peak_mem_gb"] for k, r in res.items()},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        timing="CUDA events around whole passes over the volume's 3 "
               "batches (page-locked host arrays in, host arrays out), 3 "
               "passes after 1 warm-up; window and sequential in turns")


def _quality(out: np.ndarray, gt: np.ndarray, dev="cpu") -> dict:
    """PSNR and SSIM of (n, H, W) slices against the truth, with the plain
    ops on ``dev`` (a check, not a kernel)."""
    o = torch.from_numpy(np.ascontiguousarray(out, np.float32)).to(dev)
    g = torch.from_numpy(np.ascontiguousarray(gt, np.float32)).to(dev)
    return {"psnr_db": float(psnr(o[..., None], g[..., None])),
            "ssim": float(ssim(o[..., None], g[..., None]))}


def int8_path(dev, cfg, params, lr, hr, bf16_engine) -> dict:
    SCALES_PATH.parent.mkdir(parents=True, exist_ok=True)
    SCALES_PATH.unlink(missing_ok=True)
    engine = InferenceEngine(cfg, params, bf16=True, device=dev,
                             quant="int8", quant_calib_slices=BATCH,
                             quant_calib_path=str(SCALES_PATH))
    first = engine.upscale_batch(lr)     # calibrates, freezes, serves int8
    log("int8_calibrate", batches=dict(engine._quant_batches),
        calib_slices=engine._calib_seen, frozen=not engine.quant_calibrating,
        sidecar=SCALES_PATH.exists(), summary=engine.quant_summary())
    if engine._quant_batches != {"int8": 1, "bf16": 0} or \
            engine.quant_calibrating or not SCALES_PATH.exists():
        raise AssertionError("the int8 engine did not calibrate, freeze and "
                             "re-serve the batch int8")
    names = [s for s, _ in quant_forward.quant_sites(engine._params)]
    if names != [s for s, _, _ in b4_sites(BATCH, LR, BASE_FILTERS)]:
        raise AssertionError("b4_sites does not list the int8 sites")

    kernels.reset_launch_counts()
    out = engine.upscale_batch(lr)
    counts = kernels.launch_counts()
    onepass = group_norm_leaky.onepass_launches
    stream = leaky_quantize.stream_launches
    want = dict.fromkeys(counts, 0)
    want.update(group_norm_leaky=13, leaky_quantize=13, gn_quantize=7)
    bf16_out = bf16_engine.upscale_batch(lr)
    q_int8, q_bf16 = _quality(out, hr), _quality(bf16_out, hr)
    log("int8_path", slices=BATCH, launches=counts, onepass_launches=onepass,
        stream_launches=stream,
        output=list(out.shape[1:]), int8_vs_gt=q_int8, bf16_vs_gt=q_bf16,
        mean_abs_int8_vs_bf16=float(np.abs(out - bf16_out).mean()),
        same_as_first=bool(np.array_equal(out, first)))
    if counts != want or onepass != 13 or stream != 13:
        raise AssertionError(f"int8 launch counts {counts} (B1 one-pass "
                             f"{onepass}, B4 stream {stream}), expected "
                             f"{want} (13, 13)")
    if out.shape != (BATCH, 2 * LR, 2 * LR) or not np.isfinite(out).all() \
            or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"bad int8 output: shape {out.shape}")

    # serving rates of both engines in this call, in turns
    iters = 10
    t = {"bf16": [], "int8": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        eng = bf16_engine if name == "bf16" else engine
        t[name].append(cuda_ms(lambda: eng.upscale_batch(lr), iters=iters,
                               warmup=2))
    fwd = {name: cuda_ms(lambda: eng._dispatch_once(lr), iters=iters,
                         warmup=2)
           for name, eng in (("bf16", bf16_engine), ("int8", engine))}
    rates = {name: BATCH / (sum(v) / len(v)) * 1e3 for name, v in t.items()}
    log("int8_throughput", batch=BATCH, ms_per_batch=t,
        slices_per_s=rates, forward_ms_per_batch=fwd,
        forward_slices_per_s={k: BATCH / v * 1e3 for k, v in fwd.items()},
        int8_over_bf16=rates["int8"] / rates["bf16"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # the CPU port's int8 forward with the card's frozen scales
    cpu = InferenceEngine(cfg, params, bf16=True, device="cpu",
                          quant="int8", quant_calib_path=str(SCALES_PATH))
    out_cpu = cpu.upscale_batch(lr[:2])
    g, c = _quality(out[:2], hr[:2]), _quality(out_cpu, hr[:2])
    d_psnr = abs(g["psnr_db"] - c["psnr_db"])
    ok = d_psnr <= 0.1 and cpu._quant_batches == {"int8": 1, "bf16": 0}
    log("int8_cpu_vs_gpu", slices=2, d_psnr_db=d_psnr,
        d_ssim=abs(g["ssim"] - c["ssim"]),
        mean_abs_diff=float(np.abs(out[:2] - out_cpu).mean()),
        max_abs_diff=float(np.abs(out[:2] - out_cpu).max()), ok=ok)
    if not ok:
        raise AssertionError("GPU and CPU int8 ports differ beyond the bf16 "
                             "budget")
    return counts


def probe_bound_ms() -> float:
    return bound_ms(2 * PROBE_ROWS * PROBE_LANES * 2, 0.0, torch.bfloat16)[0]


def probe_path(dev) -> tuple:
    kernels.reset_launch_counts()
    res = roll_probe.run(PROBE_ROWS, PROBE_LANES, dev)
    counts = kernels.launch_counts()
    log("roll_probe", rows=PROBE_ROWS, lanes=PROBE_LANES, results=res,
        launches={k: counts[k] for k in ("roll_copy", "roll32", "taps3")})
    if not all(counts[k] > 0 for k in ("roll_copy", "roll32", "taps3")):
        raise AssertionError(f"the probe launched no kernel: {counts}")
    bound_us = probe_bound_ms() * 1e3
    below = {f"{name}.{key}": r[key] for name, r in res.items()
             for key in ("us", "plain_us", "library_us")
             if r[key] is not None and r[key] < bound_us}
    if below:
        raise AssertionError(f"B5 times below their {bound_us} us bound: "
                             f"{below}")
    return res, counts


def _write_pngs(root: Path, n: int, lr: int) -> None:
    """``n`` seeded phantom pairs (LR lr^2, HR (2 lr)^2, 8-bit grayscale)
    under root/hr and root/lr, written by the port's PNG encoder."""
    hr_img = phantom_batch(np.random.default_rng(1), n, 2 * lr)
    lr_img = phantom_batch(np.random.default_rng(1), n, lr)
    for sub in ("hr", "lr"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        name = f"sub-{i // 10:02d}_T1w_s{i:03d}.png"
        native.imwrite_gray(str(root / "hr" / name),
                            np.round(hr_img[i] * 255).astype(np.uint8))
        native.imwrite_gray(str(root / "lr" / name),
                            np.round(lr_img[i] * 255).astype(np.uint8))


def _train_batch(dev, n, lr):
    return {"lr": torch.from_numpy(phantom_batch(
                np.random.default_rng(2), n, lr)[..., None]).to(dev),
            "hr": torch.from_numpy(phantom_batch(
                np.random.default_rng(2), n, 2 * lr)[..., None]).to(dev),
            "weight": torch.ones(n, device=dev)}


def _step_counts(fn) -> dict:
    """The launches of one call of ``fn`` by wrapper, B1's one-pass
    backward apart."""
    kernels.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    if group_norm_leaky_backward.onepass_launches:
        counts["group_norm_leaky_backward.onepass"] = \
            group_norm_leaky_backward.onepass_launches
    return counts


def _term_grads(m, loss_fn, b) -> tuple:
    """A step's loss and the gradients of its two parts: the L1 + SSIM
    terms', and the perceptual term's (their sum is the step's)."""
    params = list(m.parameters())
    total, comps = loss_fn(m(b["lr"]), b["hr"], b["weight"])
    perc = loss_fn.cfg.perceptual_weight * comps["perceptual_loss"]
    rest = torch.autograd.grad(total - perc, params, retain_graph=True)
    return total.detach(), [rest, torch.autograd.grad(perc, params)]


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """The cosine of two gradients; 1 when both are zero, 0 when one is."""
    na, nb = float(a.norm()), float(b.norm())
    if na == 0.0 or nb == 0.0:
        return 1.0 if na == nb else 0.0
    return float(a.flatten() @ b.flatten()) / (na * nb)


def _grad_gate(name: str, gg, gc, names, median: float = 2e-3,
               every: bool = True) -> tuple:
    """The training gate on gradients, card (gg) against CPU (gc),
    without the loss's part: (ok, worst tensor, gate). fp32: every
    tensor's relative L2 <= 5e-2 (unless ``every`` is False: the worst is
    then read, not gated), their median <= ``median`` (2e-3); bf16: every
    cosine >= 0.99."""
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(gg, gc)]
    cos = [_cosine(a, b) for a, b in zip(gg, gc)]
    if name == "fp32":
        i = int(np.argmax(rel))
        med = float(np.median(rel))
        return ((rel[i] <= 5e-2 or not every) and med <= median,
                {"tensor": names[i], "rel_l2": rel[i], "cosine": cos[i],
                 "median_rel_l2": med},
                ("every gradient relative L2 <= 5e-2, their median <= "
                 if every else "their median relative L2 <= ")
                + f"{median:.3g}")
    i = int(np.argmin(cos))
    return (cos[i] >= 0.99,
            {"tensor": names[i], "rel_l2": rel[i], "cosine": cos[i]},
            "gradient cosines >= 0.99")


def card_vs_cpu_step(dev, cfg, lcfg=LossConfig(), vgg_params=None,
                     tf32_too: bool = False) -> dict:
    """One step's loss and gradients on the card against the CPU port, from
    the same seeded weights and the same batch of 8 phantoms, augmentation
    off. fp32 (TF32 off): loss within rtol 1e-4; every gradient within 5e-2
    relative L2, and their median within 2e-3. bf16 (against the CPU port
    in bf16): loss within 1e-2 relative, every gradient's cosine >= 0.99.

    The fp32 gate is wider than 1e-3 a tensor because PyTorch's own CUDA
    and CPU ops differ by that much here: with every port kernel swapped
    for its plain version and cuDNN off, the card's fp32 gradients sit as
    far from the CPU's (a median of 8.2e-4, `alpha` at 2.7e-2 at batch 2),
    and the fp32 forward's output differs by 1e-3 of its range. The
    reference's GroupNorm takes E[x^2] - mean^2, which turns the two
    devices' different orders of summation into that much (PERF.md §6).
    A missing or wrong gradient is off by order 1.

    With the perceptual term (``lcfg.perceptual_weight`` > 0, VGG from
    ``vgg_params``) each of the step's two parts, the L1 + SSIM terms'
    gradient and the perceptual term's, is held to the gate alone: where
    their pulls on one tensor cancel (``alpha``: +8.6e-3 and -8.6e-3 at
    this batch, 2e-5 summed), the sum's own norm measures the
    cancellation, not the step. The perceptual part's fp32 median is
    held to the larger of 2e-3 and 1.5 times that of a control: the same
    step on the card with the port's kernels swapped for their plain
    versions (``tools/grad_gap.use_plain_kernels``), in which no port
    kernel runs. The L1 of VGG's features carries the two devices'
    different unet outputs into that part's gradient (PERF.md §6); the
    control measures how far PyTorch's own ops put it, and the port's
    kernels may add half of that again, no more.

    With ``tf32_too`` the card's step runs again with cuDNN's TF32 on
    (``torch.backends.cudnn.allow_tf32``, the mode users train in),
    against the same CPU step; there the control runs too, and the gate
    is the bf16 cosines and the fp32 parts' medians, each median held to
    the larger of 2e-3 and 1.5 times the control's in that mode; the
    fp32 parts' worst tensors are read beside the control's, not gated
    (results under ``<dtype>_tf32``)."""
    perceptual = lcfg.perceptual_weight > 0
    parts = ("L1 + SSIM", "perceptual") if perceptual else ("L1 + SSIM",)

    def make_loss(where):
        return CombinedLoss(lcfg, None if vgg_params is None else
                            vgg_mod.VGG19Features.from_params(
                                vgg_params, lcfg.vgg_layer_idx).to(where))

    sd = build_model(cfg, generator=torch.Generator().manual_seed(
        TRAIN_SEED)).state_dict()
    batch = _train_batch("cpu", TRAIN_BATCH, TRAIN_LR)
    names = [n for n, _ in build_model(cfg).named_parameters()]
    res = {}

    def step(run, where, dtype):
        m = build_model(cfg, dtype=dtype).to(where)
        m.load_state_dict(sd)
        b = {k: v.to(where) for k, v in batch.items()}
        grad_gap.use_plain_kernels(run == "control")
        t0 = time.perf_counter()
        try:
            if perceptual:
                loss, grads = _term_grads(m, make_loss(where), b)
            else:
                loss, _, g = trainer.loss_and_grads(
                    m, make_loss(where), b["hr"], b["lr"], b["weight"])
                grads = [g]
        finally:
            grad_gap.use_plain_kernels(False)
        return (float(loss), [[x.detach().double().cpu() for x in g]
                              for g in grads], time.perf_counter() - t0)

    cpu_out = {name: step("cpu", torch.device("cpu"), dtype)
               for name, dtype in (("fp32", torch.float32),
                                   ("bf16", torch.bfloat16))}
    for (name, dtype), on in ((nd, on) for nd in (("fp32", torch.float32),
                                                  ("bf16", torch.bfloat16))
                              for on in ((False, True) if tf32_too
                                         else (False,))):
        out = {"cpu": cpu_out[name]}
        torch.backends.cudnn.allow_tf32 = on
        try:
            out["card"] = step("card", dev, dtype)
            if perceptual or on:
                out["control"] = step("control", dev, dtype)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        (lg, gg, tg), (lc, gc, tc) = out["card"], out["cpu"]
        d_loss = abs(lg - lc) / abs(lc)
        ok = d_loss <= (1e-4 if name == "fp32" else 1e-2)
        gate = f"loss rtol {'1e-4' if name == 'fp32' else '1e-2'}"
        worst, control = {}, {}
        for i, part in enumerate(parts):
            median = 2e-3
            if part == "perceptual" or on:
                control[part] = _grad_gate(name, out["control"][1][i],
                                           gc[i], names)[1]
                if name == "fp32":
                    median = max(median,
                                 1.5 * control[part]["median_rel_l2"])
            ok_i, worst[part], gate_i = _grad_gate(name, gg[i], gc[i], names,
                                                   median, every=not on)
            ok = ok and ok_i
            gate += f"; {part}: {gate_i}"
        key = f"{name}_tf32" if on else name
        res[key] = {"loss_card": lg, "loss_cpu": lc, "loss_rel_diff": d_loss,
                    "worst": worst, "gate": gate, "ok": ok,
                    "cpu_s": tc, "card_s": tg, "cudnn_tf32": on}
        if "control" in out:
            res[key]["control"] = {**control, "loss": out["control"][0]}
        log("train_cpu_vs_gpu", dtype=name, loss=" + ".join(parts),
            **res[key])
        if not ok:
            raise AssertionError(f"the {name} training step on the card "
                                 f"(cuDNN TF32 {on}) and on the CPU differ "
                                 f"beyond the gate ({gate}): loss {lg} "
                                 f"against {lc}, worst gradients {worst}")
    return res


def _train_argv(ck: Path, flags=(), epochs: int = 1) -> list:
    """The train CLI's flags of the training phase (the JAX package's
    defaults, full width, its phantom PNGs), writing to ``ck``."""
    return ["--full_res_dir", str(TRAIN_DIR / "hr"),
            "--low_res_dir", str(TRAIN_DIR / "lr"),
            "--base_filters", str(BASE_FILTERS),
            "--batch_size", str(TRAIN_BATCH), "--epochs", str(epochs),
            "--seed", str(TRAIN_SEED), "--checkpoint_dir", str(ck),
            "--log_dir", str(ck / "logs"), *flags]


def _train_cli(ck: Path, flags=(), epochs: int = 1, gn: int = 20,
               b3: int = 2, start_epoch: int = 0, calib: int = 0) -> dict:
    """One in-process run of the train CLI at the JAX package's defaults
    and full width on the training phase's phantom PNGs, writing to
    ``ck``, the launch counts set to 0 just before and read just after:
    the final checkpoint, the seconds, the launches and B1's one-pass
    ones (forward and backward), the JSON lines by type, the steps and
    validation batches it ran (epochs ``start_epoch`` to ``epochs``, for
    a resume), and the launches they should make with ``gn`` B1 sites and
    ``b3`` B3 sites a forward (B2 once a batch), and ``calib`` forwards
    of QAT's calibration (no B2)."""
    argv = _train_argv(ck, flags, epochs)
    proto = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(proto):
        final = train_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    by_type = {}
    for ln in proto.getvalue().splitlines():
        if ln.startswith("{"):
            d = json.loads(ln)
            by_type.setdefault(d["type"], []).append(d)
    n_val = int(0.2 * TRAIN_PAIRS)
    steps = (epochs - start_epoch) * -(-(TRAIN_PAIRS - n_val) // TRAIN_BATCH)
    vals = (epochs - start_epoch) * -(-n_val // TRAIN_BATCH)
    want = dict.fromkeys(counts, 0)
    want.update(group_norm_leaky=gn * (steps + vals + calib),
                group_norm_leaky_backward=gn * steps,
                conv3x3=b3 * (steps + vals + calib),
                ssim_per_sample=steps + vals)
    return {"final": final, "seconds": seconds, "launches": counts,
            "expected": want, "onepass": group_norm_leaky.onepass_launches,
            "backward_onepass": group_norm_leaky_backward.onepass_launches,
            "by_type": by_type, "steps": steps, "vals": vals}


def train_path(dev, lr_serve) -> dict:
    """The training slice through its entry point: ``cli.train.main`` at
    the JAX package's defaults, full width, on a PNG set of 40 phantom
    pairs for 2 epochs; then its launch counts, one step and one
    validation batch counted alone, the card against the CPU port, the
    training rate, and serving from the final checkpoint."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    _write_pngs(TRAIN_DIR, TRAIN_PAIRS, TRAIN_LR)
    run = _train_cli(TRAIN_DIR / "ckpt", epochs=TRAIN_EPOCHS)
    final, counts, by_type = run["final"], run["launches"], run["by_type"]
    steps, vals = run["steps"], run["vals"]
    bwd_onepass = run["backward_onepass"]
    summaries = by_type.get("epoch_summary", [])
    losses = [s[k] for s in summaries for k in ("train_loss", "val_loss")] + \
        [u["loss"] for u in by_type.get("batch_update", [])]
    want = run["expected"]
    init = build_model(ModelConfig(base_filters=BASE_FILTERS),
                               generator=torch.Generator().manual_seed(
                                   TRAIN_SEED)).state_dict()
    sd = ckpt.load_checkpoint(final)[0]
    moved = max(float((sd[k] - v).abs().max()) for k, v in init.items())
    files = {n: (TRAIN_DIR / "ckpt" / f"{n}.ckpt").exists()
             for n in ("best_model_unet", "final_model_unet")}
    log("train_path", pairs=TRAIN_PAIRS, lr=[TRAIN_LR, TRAIN_LR],
        hr=[2 * TRAIN_LR, 2 * TRAIN_LR], batch=TRAIN_BATCH,
        epochs=TRAIN_EPOCHS, steps=steps, val_batches=vals,
        seconds=run["seconds"],
        launches=counts, backward_onepass_launches=bwd_onepass,
        protocol={k: len(v) for k, v in by_type.items()},
        epoch_summaries=summaries, checkpoints=files,
        max_abs_weight_change=moved)
    if counts != want or bwd_onepass != 20 * steps:
        raise AssertionError(f"training launch counts {counts} (B1 "
                             f"backward one-pass {bwd_onepass}), expected "
                             f"{want} ({20 * steps})")
    if len(by_type.get("params", [])) != 1 or len(summaries) != TRAIN_EPOCHS \
            or not by_type.get("batch_update"):
        raise AssertionError(f"bad JSON-line protocol: "
                             f"{ {k: len(v) for k, v in by_type.items()} }")
    if not all(np.isfinite(v) for v in losses) or not all(files.values()) \
            or not moved > 0.0:
        raise AssertionError(f"training did not run right: losses {losses}, "
                             f"checkpoints {files}, weight change {moved}")

    # one step and one validation batch, counted alone; then the rate
    cfg = ModelConfig(base_filters=BASE_FILTERS)
    model = build_model(cfg, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(
                                    TRAIN_SEED)).to(dev)
    state = trainer.TrainState(model, trainer.make_optimizer(
        model.parameters(), 1e-4, 1e-5))
    loss_fn = CombinedLoss(LossConfig())
    step = trainer.build_train_step(loss_fn)
    evaluate = trainer.build_eval_step(model, loss_fn)
    batch = _train_batch(dev, TRAIN_BATCH, TRAIN_LR)
    per_step = _step_counts(lambda: step(state, batch, 1e-4))
    per_val = _step_counts(lambda: evaluate(None, batch))
    log("train_step_launches", step=per_step, validation_batch=per_val)
    if per_step != {"group_norm_leaky": 20, "group_norm_leaky_backward": 20,
                    "group_norm_leaky_backward.onepass": 20,
                    "conv3x3": 2, "ssim_per_sample": 1} or \
            per_val != {"group_norm_leaky": 20, "conv3x3": 2,
                        "ssim_per_sample": 1}:
        raise AssertionError(f"per-step launches {per_step}, per validation "
                             f"batch {per_val}")
    step(state, batch, 1e-4)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch, 1e-4), iters=STEP_ITERS, warmup=2)
    log("train_throughput", batch=TRAIN_BATCH, lr=[TRAIN_LR, TRAIN_LR],
        step_ms=ms, slices_per_s=TRAIN_BATCH / ms * 1e3, steps=STEP_ITERS,
        cli_epoch_slices_per_s=[s["slices_per_sec"] for s in summaries],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        timing="CUDA events around 10 train steps after 2 warm-up steps, "
               "batch on the card, augmentation off")
    gate = card_vs_cpu_step(dev, cfg)

    # serve the final checkpoint
    engine = load_engine(InferConfig(checkpoint_path=final), device=dev)
    engine.upscale_batch(lr_serve[:2])
    kernels.reset_launch_counts()
    out = engine.upscale_batch(lr_serve)
    served = {k: v for k, v in kernels.launch_counts().items() if v}
    log("serve_trained", checkpoint=final, slices=len(lr_serve),
        output=list(out.shape[1:]), launches=served)
    if served != {"group_norm_leaky": 20, "conv3x3": 2} or \
            not np.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError(f"serving the trained checkpoint: launches "
                             f"{served}, output range [{out.min()}, "
                             f"{out.max()}]")
    return {"counts": counts, "backward_onepass_launches": bwd_onepass,
            "step_ms": ms, "gate": gate, "digests": _ckpt_digests(
                TRAIN_DIR / "ckpt"), "seconds": run["seconds"],
            "epoch_s": [e["elapsed"] for e in summaries]}


def _meta_but(path: str, keys) -> dict:
    """A checkpoint's JSON sidecar without the ``config`` fields in
    ``keys``."""
    meta = ckpt.read_meta(path)
    for k in keys:
        meta["config"].pop(k, None)
    return meta


def _remat_step(dev, cfg, batch, remat: bool) -> dict:
    """One bf16 unet training step from the training seed, with or
    without ``remat``: its launches counted alone, then its step ms (CUDA
    events, STEP_ITERS steps after 2 warm-up) and the peak memory
    allocated over them beside what was allocated before; the params
    after the first step."""
    torch.cuda.empty_cache()
    model = build_model(cfg, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(TRAIN_SEED),
                        remat=remat).to(dev)
    state = trainer.TrainState(model, trainer.make_optimizer(
        model.parameters(), 1e-4, 1e-5))
    step = trainer.build_train_step(CombinedLoss(LossConfig()))
    counts = _step_counts(lambda: step(state, batch, 1e-4))
    after_one = {k: v.detach().clone() for k, v in
                 model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ms = cuda_ms(lambda: step(state, batch, 1e-4), iters=STEP_ITERS,
                 warmup=2)
    return {"launches": counts, "step_ms": ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "allocated_before_gb": before / 1e9, "params": after_one}


def remat_profile_path(dev, trained: dict) -> dict:
    """The training phase's ``--remat`` and ``--profile_dir`` legs, on its
    pairs and seed: the train CLI with ``--remat`` (exact launches: every
    remat block's forward again in the backward, which is every B1 and B3
    site of the unet; the best and final checkpoints the same bytes as
    the training phase's, the sidecar the same but for ``remat``); one
    step with and without remat at the training batch and at the larger
    crop (launches, the same params after it, step ms, peak memory); the
    train CLI with ``--profile_dir`` (the trace of epoch 1, naming B1's
    forward and backward kernels and B2's; the same checkpoints; epoch
    1's seconds beside the training phase's)."""
    run = _train_cli(TRAIN_DIR / "ckpt_remat", ["--remat"],
                     epochs=TRAIN_EPOCHS)
    steps, vals = run["steps"], run["vals"]
    want = dict(run["expected"])
    want.update(group_norm_leaky=20 * (steps + vals) + 20 * steps,
                conv3x3=2 * (steps + vals) + 2 * steps)
    digests = _ckpt_digests(TRAIN_DIR / "ckpt_remat")
    finals = [str(d / "final_model_unet.ckpt")
              for d in (TRAIN_DIR / "ckpt", TRAIN_DIR / "ckpt_remat")]
    flags = [ckpt.read_meta(f)["config"]["remat"] for f in finals]
    paths = ("checkpoint_dir", "log_dir")
    same_meta = _meta_but(finals[0], ("remat",) + paths) == \
        _meta_but(finals[1], ("remat",) + paths)
    log("remat_train", launches=run["launches"], expected=want,
        backward_onepass=run["backward_onepass"], seconds=run["seconds"],
        plain_seconds=trained["seconds"], checkpoint_sha256=digests,
        plain_sha256=trained["digests"],
        same_bytes=digests == trained["digests"], sidecar_remat=flags,
        sidecar_equal_but_remat=same_meta,
        note="sidecars compared without the remat field and the paths "
             "the caller gave (checkpoint_dir, log_dir)")
    if run["launches"] != want or run["backward_onepass"] != 20 * steps \
            or digests != trained["digests"] or flags != [False, True] \
            or not same_meta:
        raise AssertionError(f"--remat training: launches {run['launches']}"
                             f", expected {want}; checkpoints {digests} "
                             f"against {trained['digests']}; sidecar remat "
                             f"{flags}, equal otherwise {same_meta}")

    cfg = ModelConfig(base_filters=BASE_FILTERS)
    steps_ms = {}
    for n, lr in REMAT_SHAPES:
        batch = _train_batch(dev, n, lr)
        plain = _remat_step(dev, cfg, batch, False)
        remat = _remat_step(dev, cfg, batch, True)
        same = all(torch.equal(v, remat["params"][k])
                   for k, v in plain["params"].items())
        key = f"{n}x{lr}"
        base = {k: v for k, v in plain["launches"].items()
                if not k.endswith("onepass")}
        want = dict(base, group_norm_leaky=2 * base["group_norm_leaky"],
                    conv3x3=2 * base["conv3x3"])
        got = {k: v for k, v in remat["launches"].items()
               if not k.endswith("onepass")}
        onepass = [r["launches"].get("group_norm_leaky_backward.onepass", 0)
                   for r in (plain, remat)]
        steps_ms[key] = {m: {k: r[k] for k in ("step_ms", "peak_mem_gb",
                                              "allocated_before_gb")}
                         for m, r in (("plain", plain), ("remat", remat))}
        log("remat_step", batch=n, lr=[lr, lr], hr=[2 * lr, 2 * lr],
            launches={"plain": plain["launches"],
                      "remat": remat["launches"]}, expected_remat=want,
            params_equal_after_one_step=same, **steps_ms[key],
            peak_mem_ratio=remat["peak_mem_gb"] / plain["peak_mem_gb"],
            step_ms_ratio=remat["step_ms"] / plain["step_ms"],
            timing="CUDA events around 10 steps after 2 warm-up steps; "
                   "peak: torch.cuda.max_memory_allocated over them")
        if base != {"group_norm_leaky": 20, "group_norm_leaky_backward": 20,
                    "conv3x3": 2, "ssim_per_sample": 1} or got != want or \
                onepass[0] != onepass[1] or not same:
            raise AssertionError(f"remat step at {key}: launches {got}, "
                                 f"expected {want} (plain {base}); one-pass "
                                 f"backward {onepass}; params equal {same}")
        del batch, plain, remat

    prof = TRAIN_DIR / "profile"
    shutil.rmtree(prof, ignore_errors=True)
    run = _train_cli(TRAIN_DIR / "ckpt_prof", ["--profile_dir", str(prof)],
                     epochs=TRAIN_EPOCHS)
    files = sorted(p.name for p in prof.iterdir()) if prof.exists() else []
    trace = prof / "trace_epoch1.json"
    text = trace.read_text() if trace.exists() else ""
    named = {k: k in text for k in PROFILE_KERNELS}
    said = any(f"Wrote profiler trace to {prof}" in ln.get("message", "")
               for ln in run["by_type"].get("info", []))
    epoch_s = [e["elapsed"] for e in run["by_type"].get("epoch_summary", [])]
    digests = _ckpt_digests(TRAIN_DIR / "ckpt_prof")
    log("profile_train", files=files,
        trace_mb=trace.stat().st_size / 2**20 if trace.exists() else None,
        kernels_named=named, logged=said, launches=run["launches"],
        expected=run["expected"], epoch_s=epoch_s,
        plain_epoch_s=trained["epoch_s"],
        traced_epoch_overhead_s=epoch_s[1] - trained["epoch_s"][1],
        traced_epoch_ratio=epoch_s[1] / trained["epoch_s"][1],
        same_bytes=digests == trained["digests"],
        timing="host clock of each epoch (the protocol's elapsed), the "
               "traced epoch 1 against the training phase's epoch 1")
    if files != ["trace_epoch1.json"] or not all(named.values()) or \
            not said or run["launches"] != run["expected"] or \
            digests != trained["digests"]:
        raise AssertionError(f"--profile_dir: files {files}, kernels named "
                             f"{named}, logged {said}, launches "
                             f"{run['launches']} (expected "
                             f"{run['expected']}), same checkpoints "
                             f"{digests == trained['digests']}")
    return {"step": steps_ms, "profile_epoch_s": epoch_s}


# ------------------------------------------------ QAT and the serving daemon

def _qat_step(where, cfg, sd, amax, batch) -> tuple:
    """One bf16 QAT step's loss, gradients and running amax after it, on
    ``where``, from the state_dict ``sd`` and the running ``amax``: the
    trainer's ``loss_and_grads`` through the fakequant forward (the
    unets' all-zero LR images weighing 0) and its ``update_qat_amax``;
    with the batch's foreground flag and the largest relative miss of the
    EMA rule ``decay * amax + (1 - decay) * batch statistic``."""
    m = build_model(cfg, dtype=torch.bfloat16).to(where)
    m.load_state_dict(sd)
    b = {k: v.to(where) for k, v in batch.items()}
    a = {k: v.to(where) for k, v in amax.items()}
    fq = quant_forward.build_fakequant_forward("unet", torch.bfloat16)
    loss, comps, grads = trainer.loss_and_grads(
        m, CombinedLoss(LossConfig()), b["hr"], b["lr"],
        b["weight"] * trainer.informative(m, b["lr"]), qat=(fq, a))
    new = trainer.update_qat_amax(a, comps, QAT_DECAY)
    rule = max(float(((new[k] - (QAT_DECAY * a[k] + (1 - QAT_DECAY)
                                 * comps["qat_batch_amax"][k].float()))
                      .abs() / new[k].abs().clamp_min(1e-30)).max())
               for k in a)
    return (float(loss), [g.detach().double().cpu() for g in grads],
            {k: v.cpu() for k, v in new.items()}, bool(comps["qat_any_fg"]),
            rule)


def _sidecar_ok(ck: Path) -> dict:
    """The calibration sidecars beside ``ck``'s best and final
    checkpoints: format, sites, every scale finite and > 0."""
    res = {}
    for name in ("best_model_unet", "final_model_unet"):
        path = ck / f"{name}.calib.json"
        if not path.exists():
            res[name] = {"exists": False, "ok": False}
            continue
        blob = json.loads(path.read_text())
        scales = [np.asarray(v, np.float64) for v in blob["scales"].values()]
        res[name] = {"exists": True, "format": blob["format"],
                     "sites": len(scales),
                     "min_scale": float(min(v.min() for v in scales)),
                     "ok": blob["format"] == quant_forward.SCALES_FORMAT
                     and len(scales) == 20
                     and all(np.isfinite(v).all() and (v > 0).all()
                             for v in scales)}
    return res


def _qat_cli(ck: Path, flags, epochs: int, start_epoch: int = 0) -> dict:
    """A --qat run of the train CLI (one calibration forward at its
    start), checked: exit, finite train losses that fall from the first
    epoch to the last, exact launches, B1's backward all one-pass, and
    both sidecars."""
    run = _train_cli(ck, ["--qat", "--qat_decay", str(QAT_DECAY), *flags],
                     epochs=epochs, start_epoch=start_epoch, calib=1)
    summaries = run["by_type"].get("epoch_summary", [])
    losses = [s["train_loss"] for s in summaries]
    side = _sidecar_ok(ck)
    ok = (run["launches"] == run["expected"]
          and run["backward_onepass"] == 20 * run["steps"]
          and len(losses) == epochs - start_epoch >= 2
          and all(np.isfinite(v) for v in losses) and losses[-1] < losses[0]
          and all(v["ok"] for v in side.values()))
    log("qat_train", flags=["--qat", *flags], epochs=[start_epoch, epochs],
        seconds=run["seconds"], launches=run["launches"],
        expected=run["expected"], backward_onepass=run["backward_onepass"],
        train_losses=losses,
        val_losses=[s["val_loss"] for s in summaries], sidecars=side, ok=ok)
    if not ok:
        raise AssertionError(f"QAT training {flags}: launches "
                             f"{run['launches']} against {run['expected']}, "
                             f"losses {losses}, sidecars {side}")
    return run


def qat_path(dev, lr, hr) -> dict:
    """Quantization-aware training at full width (unet, base filters 32,
    bf16): one step on the card against the CPU port from the same weights
    and running amax (batch 8 of 128^2 -> 256^2; the amax starts at half
    the batch's calibration, and must move by the EMA rule on each
    device), its launches counted alone; the train CLI with --qat from
    scratch on the training phase's pairs, then --qat --resume of the
    training phase's bf16 checkpoint; and the fakequant forward of the
    QAT checkpoint against its int8 forward with the same scales, on the
    serving batch."""
    shutil.rmtree(QAT_DIR, ignore_errors=True)
    QAT_DIR.mkdir(parents=True)
    cfg = ModelConfig(base_filters=BASE_FILTERS)
    sd = build_model(cfg, generator=torch.Generator().manual_seed(
        TRAIN_SEED)).state_dict()
    batch = _train_batch("cpu", TRAIN_BATCH, TRAIN_LR)
    amax = {k: QAT_AMAX_START * v for k, v in quant_forward.calib_amax(
        sd, batch["lr"], "unet", torch.bfloat16).items()}
    names = [n for n, _ in build_model(cfg).named_parameters()]
    (lg, gg, ag, fg_g, rule_g), (lc, gc, ac, fg_c, rule_c) = (
        _qat_step(where, cfg, sd, amax, batch) for where in (dev, "cpu"))
    moved = {w: min(float(((new[k] - amax[k]).abs() / amax[k].clamp_min(
        1e-30)).max()) for k in amax) for w, new in (("card", ag),
                                                       ("cpu", ac))}
    d_loss = abs(lg - lc) / abs(lc)
    ok_g, worst, gate = _grad_gate("bf16", gg, gc, names)
    amax_rel = max(float(((ag[k] - ac[k]).abs() / ac[k].abs().clamp_min(
        1e-30)).max()) for k in ac)
    ok = d_loss <= 1e-2 and ok_g and amax_rel <= QAT_AMAX_RTOL and \
        fg_g == fg_c and fg_g and max(rule_g, rule_c) <= QAT_RULE_RTOL
    log("qat_cpu_vs_gpu", batch=TRAIN_BATCH, lr=[TRAIN_LR, TRAIN_LR],
        loss_card=lg, loss_cpu=lc, loss_rel_diff=d_loss, worst=worst,
        amax_max_rel_diff=amax_rel, any_fg=[fg_g, fg_c],
        amax_start=f"{QAT_AMAX_START} x the batch's calibration",
        ema_rule_max_rel_miss={"card": rule_g, "cpu": rule_c},
        least_site_largest_move=moved,
        gate=f"loss rtol 1e-2; {gate}; updated amax rtol {QAT_AMAX_RTOL}; "
             f"any_fg equal and true; the EMA rule within "
             f"{QAT_RULE_RTOL} on each device", ok=ok)
    if not ok:
        raise AssertionError(f"the QAT step on the card and on the CPU "
                             f"differ: loss {lg} against {lc}, {worst}, "
                             f"amax {amax_rel}, any_fg {fg_g} {fg_c}, EMA "
                             f"rule missed by {rule_g} {rule_c}")

    model = build_model(cfg, dtype=torch.bfloat16).to(dev)
    model.load_state_dict(sd)
    state = trainer.TrainState(model, trainer.make_optimizer(
        model.parameters(), 1e-4, 1e-5), 0, None,
        {k: v.to(dev) for k, v in amax.items()})
    step = trainer.build_train_step(
        CombinedLoss(LossConfig()), qat_fwd=quant_forward.
        build_fakequant_forward("unet", torch.bfloat16), qat_decay=QAT_DECAY)
    b = _train_batch(dev, TRAIN_BATCH, TRAIN_LR)
    per_step = _step_counts(lambda: step(state, b, 1e-4))
    step(state, b, 1e-4)
    ms = cuda_ms(lambda: step(state, b, 1e-4), iters=STEP_ITERS, warmup=2)
    log("qat_step_launches", step=per_step, step_ms=ms,
        slices_per_s=TRAIN_BATCH / ms * 1e3,
        timing="CUDA events around 10 QAT steps after 2 warm-up steps")
    if per_step != {"group_norm_leaky": 20, "group_norm_leaky_backward": 20,
                    "group_norm_leaky_backward.onepass": 20, "conv3x3": 2,
                    "ssim_per_sample": 1}:
        raise AssertionError(f"QAT step launches {per_step}")

    scratch = _qat_cli(QAT_DIR / "scratch", [], epochs=TRAIN_EPOCHS)
    ft = QAT_DIR / "ft"
    ft.mkdir()
    for ext in (".ckpt", ".json"):
        shutil.copy(TRAIN_DIR / "ckpt" / f"final_model_unet{ext}",
                    ft / f"final_model_unet{ext}")
    tuned = _qat_cli(ft, ["--resume"], epochs=TRAIN_EPOCHS + QAT_FT_EPOCHS,
                     start_epoch=TRAIN_EPOCHS)
    if not any("histories are reset" in ln.get("message", "")
               for ln in tuned["by_type"].get("info", [])):
        raise AssertionError("the --qat --resume of a bf16 checkpoint did "
                             "not reset its histories")

    # the QAT checkpoint's fakequant forward against its int8 forward,
    # with the scales of its running ranges (those of its sidecar)
    final = scratch["final"]
    sd_q, _, _, extras = ckpt.load_checkpoint(final, return_extras=True)
    sd_q = {k: v.to(dev) for k, v in sd_q.items()}
    qa = {k: v.to(dev) for k, v in extras["qat_amax"].items()}
    scales = quant_forward.scales_from_amax(
        {k: v.cpu().numpy() for k, v in qa.items()})
    side, _ = quant_forward.load_scales(ckpt.calib_sidecar_path(final))
    x = torch.from_numpy(lr[..., None]).to(dev)
    with torch.inference_mode():
        y_fq = quant_forward.build_fakequant_forward("unet", torch.bfloat16)(
            sd_q, qa, x)[0][..., 0].float().cpu().numpy()
        y_i8 = quant_forward.build_int8_forward(
            sd_q, scales, "unet", torch.bfloat16)(sd_q, x)[..., 0].float(
            ).cpu().numpy()
    qf_, qi = _quality(y_fq, hr), _quality(y_i8, hr)
    d = {"d_psnr_db": abs(qf_["psnr_db"] - qi["psnr_db"]),
         "d_ssim": abs(qf_["ssim"] - qi["ssim"])}
    same = all(np.array_equal(side[k], scales[k]) for k in scales)
    log("qat_fakequant_vs_int8", slices=BATCH, fakequant=qf_, int8=qi,
        mean_abs_diff=float(np.abs(y_fq - y_i8).mean()),
        sidecar_equals_running_ranges=same,
        gate="|dPSNR| <= 0.1 dB (the int8 budget)", **d)
    if d["d_psnr_db"] > 0.1 or not same:
        raise AssertionError(f"QAT fakequant against int8: {d}; sidecar "
                             f"is the running ranges' scales: {same}")
    totals = dict.fromkeys(kernels.launch_counts(), 0)
    for counts in (scratch["launches"], tuned["launches"]):
        for k, v in counts.items():
            totals[k] += v
    log("qat_path", launches=totals)
    return {"launches": totals, "final": final, "step_ms": ms}


@contextlib.contextmanager
def _daemon(backend, max_batch: int, window_ms: float = 5.0):
    """``serve_http`` on port 0 in this process, serving on a thread; its
    base URL and server. One at a time: a process runs one batcher's
    worker on the card."""
    server = serve_http(backend, port=0, max_batch=max_batch,
                        batch_window_ms=window_ms, max_pending=4096)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        thread.join(30)


def _http(base: str, path: str, data: bytes = None,
          timeout: float = 120) -> bytes:
    req = urllib.request.Request(base + path, data=data)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _from_npy(b: bytes) -> np.ndarray:
    return np.load(io.BytesIO(b))


def _daemon_counts(stats: dict, hist: dict, counts: dict, per: dict,
                   routes: dict) -> tuple:
    """The launches a daemon leg must show: ``per`` a forward times the
    batches its histogram counts; B1's and B4's routes too."""
    batches = stats["batches"]
    want = dict.fromkeys(counts, 0)
    want.update({k: v * batches for k, v in per.items()})
    want_routes = {k: v * batches for k, v in routes.items()}
    return want, want_routes, sum(hist.values()) == batches


# the load generator of the bf16 leg: a process of its own (numpy and the
# stdlib), so that the clients do not share the daemon's interpreter
SERVE_CLIENT = r"""
import io, json, sys, threading, time, urllib.request
import numpy as np
base, src, dst = sys.argv[1:4]
clients, per = int(sys.argv[4]), int(sys.argv[5])
lrs = np.load(src)
out = np.zeros((len(lrs), 2 * lrs.shape[1], 2 * lrs.shape[2]), np.float32)
lat, lock = [], threading.Lock()

def post(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(base + "/upscale", data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.load(io.BytesIO(resp.read()))

def client(c):
    lo = c * per
    jobs = [(i, i + 1) for i in range(lo, lo + per // 2)]
    jobs.append((lo + per // 2, lo + per))
    for a, e in jobs:
        t = time.perf_counter()
        y = post(lrs[a] if e == a + 1 else lrs[a:e])
        with lock:
            lat.append((time.perf_counter() - t) * 1e3)
        out[a:e] = y.reshape((e - a,) + y.shape[-2:])

threads = [threading.Thread(target=client, args=(c,))
           for c in range(clients)]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join(300)
wall = time.perf_counter() - t0
np.save(dst, out)
print(json.dumps({"wall_s": wall, "latency_ms": sorted(lat)}))
"""


def _serve_bf16(dev, cfg, params) -> dict:
    """16 clients (threads of a process of their own) post 128 slices of
    256^2, each 4 alone and a stack of 4, to the bf16 daemon; every output
    against the same slice through ``upscale_batch`` at the bf16 budget
    (against the phantom truth), the stats, and 20 one-pass B1 and 2 B3
    launches a batch. The engine is warmed at every batch size the
    batcher pads to (the first call at a new size is timed apart), as a
    server is before it takes traffic."""
    n = SERVE_CLIENTS * SERVE_PER_CLIENT
    lrs = phantom_batch(np.random.default_rng(SERVE_SEED), n, LR)
    hrs = phantom_batch(np.random.default_rng(SERVE_SEED), n, 2 * LR)
    engine = InferenceEngine(cfg, params, bf16=True, device=dev)
    first_call_ms = {}
    for b in (BATCH, 1, 2, 4, 8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.upscale_batch(lrs[:b])
        first_call_ms[b] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = np.concatenate([engine.upscale_batch(lrs[i:i + BATCH])
                             for i in range(0, n, BATCH)])
    direct_s = time.perf_counter() - t0
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    src, dst = SERVE_DIR / "client_in.npy", SERVE_DIR / "client_out.npy"
    np.save(src, lrs)
    kernels.reset_launch_counts()
    with _daemon(engine, max_batch=BATCH) as (server, base):
        r = subprocess.run([sys.executable, "-c", SERVE_CLIENT, base,
                            str(src), str(dst), str(SERVE_CLIENTS),
                            str(SERVE_PER_CLIENT)], capture_output=True,
                           text=True, timeout=600)
        metrics = json.loads(_http(base, "/metrics"))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        routes = {"group_norm_leaky.onepass":
                  group_norm_leaky.onepass_launches}
    if r.returncode != 0:
        raise AssertionError(f"the client process failed: {r.stderr[-2000:]}")
    load = json.loads(r.stdout.strip().splitlines()[-1])
    lat = load["latency_ms"]
    got = np.load(dst)
    worst = {"d_psnr_db": 0.0, "d_ssim": 0.0}
    for i in range(n):
        g, w = _quality(got[i:i + 1], hrs[i:i + 1], dev), _quality(
            direct[i:i + 1], hrs[i:i + 1], dev)
        worst["d_psnr_db"] = max(worst["d_psnr_db"],
                                 abs(g["psnr_db"] - w["psnr_db"]))
        worst["d_ssim"] = max(worst["d_ssim"], abs(g["ssim"] - w["ssim"]))
    stats, hist = metrics["stats"], metrics["batch_size_hist"]
    want, want_routes, hist_ok = _daemon_counts(
        stats, hist, counts, {"group_norm_leaky": 20, "conv3x3": 2},
        {"group_norm_leaky.onepass": 20})
    n_req = SERVE_CLIENTS * (SERVE_PER_CLIENT // 2 + 1)
    rates = {"http_slices_per_s": n / load["wall_s"],
             "upscale_batch_slices_per_s": n / direct_s,
             "latency_ms_p50": lat[len(lat) // 2],
             "latency_ms_p99": lat[min(len(lat) - 1,
                                       int(round(0.99 * (len(lat) - 1))))],
             "requests": len(lat), "first_call_ms_by_batch": first_call_ms}
    ok = bool(stats["requests"] == n and stats["errors"] == 0
              and stats["abandoned"] == 0 and hist_ok and counts == want
              and routes == want_routes and len(lat) == n_req
              and worst["d_psnr_db"] <= 0.1 and worst["d_ssim"] <= 1e-3
              and np.isfinite(got).all())
    log("serve_bf16", clients=SERVE_CLIENTS, slices=n, stats=stats,
        batch_size_hist=hist, launches=counts, expected=want, routes=routes,
        worst_slice_vs_upscale_batch=worst,
        max_abs_diff=float(np.abs(got - direct).max()), ok=ok)
    log("serve_throughput", **rates, upscale_batch_batch=BATCH,
        timing="wall clock of 16 client threads, in a process of their "
               "own, posting 80 requests (128 slices) over HTTP on "
               "127.0.0.1, the engine warm at every padded batch size; "
               "upscale_batch: 8 calls of 16 slices in turn, host in and "
               "out")
    if not ok:
        raise AssertionError(f"bf16 daemon: stats {stats}, launches {counts}"
                             f" against {want}, routes {routes}, worst "
                             f"slice {worst}, {len(lat)} of {n_req} "
                             f"requests")
    return {"launches": counts, "rates": rates, "direct": direct[:2],
            "lrs": lrs[:2], "hrs": hrs[:2]}


def _two_member_gzip(body: bytes) -> bytes:
    cut = len(body) - (len(body) - 352) // 2
    return gzip.compress(body[:cut], 1) + gzip.compress(body[cut:], 1)


def _serve_raw(dev) -> dict:
    """The --serve_raw --out_dtype int16 daemon (the volume phase's
    checkpoint, max_batch = the CLI's batch): the volume phase's int16
    volume posted as .nii, .nii.gz and a .nii.gz of two members, each
    against the infer_volume CLI's --serve_raw --out_dtype int16 output
    (header fields, voxels within one code); one non-square raw slice
    through /upscale in the transposed layout."""
    engine = load_engine(InferConfig(
        checkpoint_dir=str(VOL_DIR / "ckpt"), normalize_inputs=True,
        transpose_io=True, out_dtype="int16"), device=dev)
    body = (VOL_DIR / "vol.nii").read_bytes()
    want, _ = nifti.load(str(VOL_DIR / "sr_b.nii"), raw=True)
    stored, _ = nifti.load(str(VOL_DIR / "vol.nii"), raw=True)
    nonsq = np.ascontiguousarray(stored[:, :NONSQ_W, VOL_SLICES // 2])
    ref = engine.upscale_batch(nonsq[None])[0]   # before the worker starts
    posts = {"nii": body, "nii.gz": gzip.compress(body, 1),
             "nii.gz, 2 members": _two_member_gzip(body)}
    res = {}
    kernels.reset_launch_counts()
    with _daemon(engine, max_batch=VOL_BATCH) as (server, base):
        for name, data in posts.items():
            t0 = time.perf_counter()
            out = _http(base, "/upscale_volume", data, timeout=300)
            seconds = time.perf_counter() - t0
            if out[:2] == b"\x1f\x8b":
                out = gzip.decompress(out)
            vol, hdr = nifti.load_bytes(out, raw=True)
            diff = int(np.abs(vol.astype(np.int32) - want).max()) \
                if vol.shape == want.shape else None
            r = {"shape": list(vol.shape), "dtype": str(vol.dtype),
                 "zooms": list(hdr.zooms), "scl_slope": hdr.scl_slope,
                 "max_code_diff_vs_cli": diff, "seconds": seconds,
                 "gzip_out": name != "nii"}
            r["ok"] = bool(vol.shape == (2 * VOL_HW, 2 * VOL_HW, VOL_SLICES)
                       and vol.dtype == np.int16
                       and np.allclose(hdr.zooms, (0.5, 0.5, 3.0))
                       and math.isclose(hdr.scl_slope, 1 / 32767,
                                        rel_tol=1e-6)
                       and diff is not None and diff <= 1)
            res[name] = r
        y = _from_npy(_http(base, "/upscale", _npy(nonsq)))
        metrics = json.loads(_http(base, "/metrics"))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    res["nonsquare_upscale"] = {
        "posted": list(nonsq.shape), "returned": list(y.shape),
        "max_code_diff_vs_engine": int(np.abs(
            y.astype(np.int32) - ref).max()) if y.shape == ref.shape
        else None}
    res["nonsquare_upscale"]["ok"] = bool(
        y.shape == (2 * nonsq.shape[0], 2 * nonsq.shape[1])
        and y.dtype == np.int16
        and res["nonsquare_upscale"]["max_code_diff_vs_engine"] == 0)
    stats = metrics["stats"]
    want_l, _, hist_ok = _daemon_counts(
        stats, metrics["batch_size_hist"], counts,
        {"group_norm_leaky": 20, "conv3x3": 2}, {})
    ok = all(r["ok"] for r in res.values()) and counts == want_l and \
        hist_ok and stats["errors"] == 0
    log("serve_raw", posts=res, stats=stats,
        batch_size_hist=metrics["batch_size_hist"], launches=counts,
        expected=want_l, ok=ok)
    if not ok:
        raise AssertionError(f"raw int16 daemon: {res}, launches {counts} "
                             f"against {want_l}")
    return {"launches": counts}


def _serve_int8(dev, qat_final: str, lrs: np.ndarray,
                hrs: np.ndarray) -> dict:
    """The QAT checkpoint served int8 through the daemon: ``load_engine``
    finds its sidecar, so every content batch is int8 from the first,
    with no calibration forward; 13 B1 (one-pass), 7 ``gn_quantize`` and
    13 B4 (stream) launches a batch. The daemon's stack and single slice
    against the same engine's ``upscale_batch`` on the stack before the
    worker starts, each slice at the bf16 budget (bit-equality logged);
    both against what QAT trained, the checkpoint's fakequant forward
    with its running ranges, at the int8 budget (|dPSNR| <= 0.1 dB),
    all against the phantom truth ``hrs``. The checkpoint's bf16 engine
    is read beside them, not gated: a QAT checkpoint's int8 sits from its
    float forward by what its training left, as its fakequant forward
    does (logged as the control)."""
    engine = load_engine(InferConfig(checkpoint_path=qat_final,
                                     quant="int8"), device=dev)
    frozen = not engine.quant_calibrating
    ref = engine.upscale_batch(lrs)          # before the worker starts
    ref_batches = dict(engine._quant_batches)
    bf16 = load_engine(InferConfig(checkpoint_path=qat_final),
                       device=dev).upscale_batch(lrs)
    sd_q, _, _, extras = ckpt.load_checkpoint(qat_final, return_extras=True)
    with torch.inference_mode():
        fq = quant_forward.build_fakequant_forward("unet", torch.bfloat16)(
            {k: v.to(dev) for k, v in sd_q.items()},
            {k: v.to(dev) for k, v in extras["qat_amax"].items()},
            torch.from_numpy(lrs[..., None]).to(dev))[0][..., 0].float(
            ).cpu().numpy()
    kernels.reset_launch_counts()
    with _daemon(engine, max_batch=BATCH) as (server, base):
        out = _from_npy(_http(base, "/upscale", _npy(lrs)))
        single = _from_npy(_http(base, "/upscale", _npy(lrs[0])))
        metrics = json.loads(_http(base, "/metrics"))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        routes = {"group_norm_leaky.onepass":
                  group_norm_leaky.onepass_launches,
                  "leaky_quantize.stream": leaky_quantize.stream_launches}
    stats = metrics["stats"]
    want, want_routes, hist_ok = _daemon_counts(
        stats, metrics["batch_size_hist"], counts,
        {"group_norm_leaky": 13, "gn_quantize": 7, "leaky_quantize": 13},
        {"group_norm_leaky.onepass": 13, "leaky_quantize.stream": 13})
    quant = metrics["quant_batches"]
    shapes = bool(out.shape == (len(lrs), 2 * LR, 2 * LR)
                  and single.shape == (2 * LR, 2 * LR))
    vs_engine, vs_fq, vs_bf16 = {}, {}, {}
    if shapes:
        got = {"stack": out, "single": single[None]}
        for name, y in got.items():
            worst = {"d_psnr_db": 0.0, "d_ssim": 0.0, "ok": True}
            for i in range(len(y)):
                d = _budget_quiet(_quality(y[i:i + 1], hrs[i:i + 1]),
                                  _quality(ref[i:i + 1], hrs[i:i + 1]))
                worst = {k: max(worst[k], d[k]) if k != "ok"
                         else worst[k] and d[k] for k in worst}
            vs_engine[name] = {**worst, "bit_equal": bool(np.array_equal(
                y, ref[:len(y)])), "max_abs_diff": float(np.abs(
                    y - ref[:len(y)]).max())}
            q, qf_, qb = (_quality(y, hrs[:len(y)]),
                          _quality(fq[:len(y)], hrs[:len(y)]),
                          _quality(bf16[:len(y)], hrs[:len(y)]))
            vs_fq[name] = {"int8": q, "fakequant": qf_, "d_psnr_db": abs(
                q["psnr_db"] - qf_["psnr_db"]), "d_ssim": abs(
                q["ssim"] - qf_["ssim"])}
            vs_fq[name]["ok"] = vs_fq[name]["d_psnr_db"] <= 0.1
            vs_bf16[name] = {"bf16": qb, "d_psnr_db_int8": q["psnr_db"]
                             - qb["psnr_db"], "d_psnr_db_fakequant":
                             qf_["psnr_db"] - qb["psnr_db"]}
    ok = bool(frozen and ref_batches == {"int8": 1, "bf16": 0}
              and quant == {"int8": stats["batches"] + 1, "bf16": 0}
              and counts == want and routes == want_routes and hist_ok
              and shapes and np.isfinite(out).all() and stats["errors"] == 0
              and all(v["ok"] for v in vs_engine.values())
              and all(v["ok"] for v in vs_fq.values()))
    log("serve_int8", checkpoint=qat_final, frozen_at_load=frozen,
        quant_batches=quant, stats=stats,
        batch_size_hist=metrics["batch_size_hist"], launches=counts,
        expected=want, routes=routes, vs_upscale_batch=vs_engine,
        vs_fakequant=vs_fq, vs_bf16_engine_read=vs_bf16,
        gate="each slice against upscale_batch at the bf16 budget; "
             "against the fakequant forward |dPSNR| <= 0.1 dB (the int8 "
             "budget)", ok=ok)
    if not ok:
        raise AssertionError(f"int8 daemon from the QAT checkpoint: quant "
                             f"{quant}, launches {counts} against {want}, "
                             f"routes {routes}; against upscale_batch "
                             f"{vs_engine}; against the fakequant "
                             f"forward {vs_fq}")
    return {"launches": counts}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_cli(lrs: np.ndarray, direct: np.ndarray, hrs: np.ndarray) -> dict:
    """``cli/serve.py`` as a process of its own on the volume phase's
    checkpoint: /healthz answers, one /upscale against the same slice
    through ``upscale_batch`` at the bf16 budget; then a SIGTERM while a
    request waits in the batch window: the request completes, the process
    exits 0."""
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    t_start = time.perf_counter()
    with open(SERVE_DIR / "serve_cli.log", "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mri_superresolution_torch.cli.serve",
             "--checkpoint_dir", str(VOL_DIR / "ckpt"), "--port", str(port),
             "--batch_window_ms", "500", "--max_batch", str(BATCH)],
            cwd=str(SERVE_DIR), env=env, stdout=logf, stderr=logf)
        try:
            deadline = time.monotonic() + 180
            while True:
                try:
                    health = json.loads(_http(base, "/healthz", timeout=5))
                    break
                except (urllib.error.URLError, ConnectionError):
                    if proc.poll() is not None or \
                            time.monotonic() > deadline:
                        raise AssertionError(
                            f"serve CLI did not come up (exit "
                            f"{proc.poll()}); see {SERVE_DIR}/serve_cli.log")
                    time.sleep(0.25)
            ready_s = time.perf_counter() - t_start
            first = _from_npy(_http(base, "/upscale", _npy(lrs[0])))
            got = []
            t = threading.Thread(target=lambda: got.append(_from_npy(_http(
                base, "/upscale", _npy(lrs[1]), timeout=120))))
            t.start()
            time.sleep(0.2)                  # inside the 500 ms window
            proc.send_signal(signal.SIGTERM)
            t.join(120)
            rc = proc.wait(120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    checks = {k: _budget_quiet(_quality(y[None], hrs[i:i + 1]),
                               _quality(direct[i:i + 1], hrs[i:i + 1]))
              for k, i, y in (("first", 0, first),
                              ("in_flight", 1, got[0] if got else
                               np.zeros_like(first)))}
    ok = rc == 0 and bool(got) and health["status"] == "ok" and \
        all(c["ok"] for c in checks.values())
    log("serve_cli", health=health, seconds_to_ready=ready_s,
        sigterm_exit=rc, in_flight_completed=bool(got), checks=checks,
        ok=ok)
    if not ok:
        raise AssertionError(f"serve CLI: exit {rc} after SIGTERM, in-flight "
                             f"request completed {bool(got)}, {checks}")
    return {"rc": rc}


def serve_path(dev, cfg, params, qat_final: str) -> dict:
    """The serving daemon through its entry points: ``serve_http`` in this
    process with three backends, one after another (bf16 at 16 clients;
    --serve_raw --out_dtype int16 on whole volumes; int8 from the QAT
    checkpoint's sidecar), then ``cli/serve.py`` as a process of its own.
    The launches of the three in-process legs are returned."""
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    bf16 = _serve_bf16(dev, cfg, params)
    raw = _serve_raw(dev)
    int8 = _serve_int8(dev, qat_final, phantom_batch(
        np.random.default_rng(SERVE_SEED), BATCH, LR), phantom_batch(
        np.random.default_rng(SERVE_SEED), BATCH, 2 * LR))
    _serve_cli(bf16["lrs"], bf16["direct"], bf16["hrs"])
    totals = dict.fromkeys(kernels.launch_counts(), 0)
    for leg in (bf16, raw, int8):
        for k, v in leg["launches"].items():
            totals[k] += v
    log("serve_path", launches=totals)
    return {"launches": totals, "rates": bf16["rates"]}


# ---------------------------------------------------- serving artifacts

ARTIFACT_CLIENT = r"""
import json, sys, time
import numpy as np
import torch
from mri_superresolution_torch import kernels, nifti
from mri_superresolution_torch.infer.export import load_artifact
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.subproc import child_env
args = json.loads(sys.argv[1])
lr = phantom_batch(np.random.default_rng(0), args["batch"], args["size"])
raw = nifti.load(args["volume"], raw=True)[0].T[:args["batch"]]
inputs = {"phantom": lr, "phantom_192": lr[:, :, :args["width"]],
          "black": np.zeros_like(lr), "raw": np.ascontiguousarray(raw)}
res, outs = {}, {}
for name, path, batches in args["artifacts"]:
    t0 = time.perf_counter()
    art = load_artifact(path)
    torch.cuda.synchronize()
    res[name] = {"load_s": time.perf_counter() - t0}
    for b in batches:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        outs[name + "." + b] = art.upscale_batch(inputs[b])
        res[name][b] = {"first_call_ms": (time.perf_counter() - t0) * 1e3,
                        "launches": {k: v for k, v in
                                     kernels.launch_counts().items() if v}}
np.savez(args["out"], **outs)
print(json.dumps({"artifacts": res, "model_modules": sorted(
    m for m in sys.modules if m.startswith((
        "mri_superresolution_torch.models", "mri_superresolution_torch.train",
        "mri_superresolution_torch.infer.engine")))}))
"""


def _files_digest(*dirs: Path) -> str:
    """SHA-256 over the names and bytes of every file in ``dirs``, in
    sorted order: the same digest in two calls means the same data."""
    import hashlib
    h = hashlib.sha256()
    for d in dirs:
        for f in sorted(d.iterdir()):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()


def _ckpt_digests(ck: Path) -> dict:
    """SHA-256 of the best and final checkpoints' bytes in ``ck``."""
    import hashlib
    return {n: hashlib.sha256((ck / f"{n}.ckpt").read_bytes()).hexdigest()
            for n in ("best_model_unet", "final_model_unet")}


def _export_all(qat_final: str):
    """The export CLI in a process of its own a mode, all started
    together; returns a function that waits for them and gives each one's
    seconds, the artifact's MiB and its path, and the wall time of all."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    ck = {"vol": ["--checkpoint_dir", str(VOL_DIR / "ckpt")],
          "qat": ["--checkpoint_dir", str(Path(qat_final).parent),
                  "--checkpoint_path", qat_final]}
    procs = {}
    for mode, (src, flags, _) in ART_MODES.items():
        out = ART_DIR / f"{mode}.mrisrt"
        procs[mode] = (out, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "mri_superresolution_torch.cli."
             "export_serving", "--out", str(out), "--base_filters",
             str(BASE_FILTERS), *ck[src], *flags], cwd=str(ART_DIR), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    def wait() -> dict:
        res = {}
        for mode, (out, t0, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("Wrote ")]
            if proc.returncode or not line:
                raise AssertionError(f"export {mode}: exit "
                                     f"{proc.returncode}: {stderr[-3000:]}")
            res[mode] = {"path": str(out),
                         "seconds": time.perf_counter() - t0,
                         "mib": os.path.getsize(out) / 2 ** 20,
                         "line": line[0]}
        return res

    return wait


def _start_artifact_daemon(path: str):
    """``cli/serve.py --artifact`` started as a process of its own, with
    ``--bucket`` (named as ignored); returns (process, base URL)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    with open(ART_DIR / "serve_cli.log", "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mri_superresolution_torch.cli.serve",
             "--artifact", path, "--port", str(port), "--bucket", "8",
             "--max_batch", str(BATCH)], cwd=str(ART_DIR), env=env,
            stdout=logf, stderr=logf)
    return proc, f"http://127.0.0.1:{port}"


def _artifact_daemon(proc, base: str, lrs: np.ndarray, hrs: np.ndarray,
                     want: np.ndarray) -> dict:
    """The daemon of :func:`_start_artifact_daemon`: /healthz describes
    the artifact; a stack of 4 slices and one slice alone over HTTP, each
    against the artifact's ``upscale_batch`` of the stack at the bf16
    budget (the daemon coalesces other batch sizes, at which cuDNN may sum
    in another order), bit-equality logged; a SIGTERM ends it with exit
    0."""
    try:
        deadline = time.monotonic() + 180
        while True:
            try:
                health = json.loads(_http(base, "/healthz", timeout=5))
                break
            except (urllib.error.URLError, ConnectionError):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(
                        f"serve CLI --artifact did not come up (exit "
                        f"{proc.poll()}); see {ART_DIR}/serve_cli.log")
                time.sleep(0.25)
        stack = _from_npy(_http(base, "/upscale", _npy(lrs[:4])))
        one = _from_npy(_http(base, "/upscale", _npy(lrs[4])))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    got = np.concatenate([stack, one[None]])
    checks = [_budget_quiet(_quality(got[i:i + 1], hrs[i:i + 1]),
                            _quality(want[i:i + 1], hrs[i:i + 1]))
              for i in range(5)]
    logged = (ART_DIR / "serve_cli.log").read_text()
    ok = rc == 0 and health.get("artifact", {}).get("mode") == "plain" \
        and "--bucket is IGNORED" in logged and all(c["ok"] for c in checks)
    log("artifact_daemon", health=health, sigterm_exit=rc,
        bit_equal=[bool(np.array_equal(got[i], want[i])) for i in range(5)],
        worst={k: max(c[k] for c in checks)
               for k in ("d_psnr_db", "d_ssim")}, ok=ok)
    if not ok:
        raise AssertionError(f"serve CLI --artifact: exit {rc}, health "
                             f"{health}, {checks}")
    return {"rc": rc}


def _rates(fns: dict, batch: np.ndarray) -> dict:
    """slices/s of each ``fn(batch)`` (it returns a host array, so a call
    ends synchronized), in turns a, b, b, a after two warm-up calls."""
    for fn in fns.values():
        for _ in range(2):
            fn(batch)
    names = list(fns)
    out = {k: [] for k in names}
    for k in names + names[::-1]:
        t0 = time.perf_counter()
        for _ in range(ART_RATE_ITERS):
            fns[k](batch)
        out[k].append(len(batch) * ART_RATE_ITERS
                      / (time.perf_counter() - t0))
    return out


def artifact_path(dev, lr, hr, qat_final: str, train_digests: dict) -> dict:
    """Portable serving artifacts through their entry points, on the
    full-width unet in bf16: the export CLI a process a mode (plain at
    256^2 and 256 x 192 and raw int16 at the volume's 256^2 from the volume
    phase's checkpoint, tta at 256^2, int8 from the QAT checkpoint's
    sidecar); a fresh process that loads each, serves the phantom batch
    (and a black one, and the volume's slices) and imports none of the
    model zoo, the trainer or the engine; each output against the port's
    engine on the same checkpoint, bit for bit (tta: the engine's on-card
    TTA; the black batch: int8's fallback, by its launches); the launches
    a batch; the artifact's slices/s beside the engine's; the volume
    through ``cli.infer_volume --artifact`` voxel for voxel against the
    volume phase's run from the checkpoint; the daemon on the plain
    artifact; the card-made artifact on the CPU against the CPU port at
    the bf16 budget; and the training phase's train CLI run again, its
    checkpoints against that phase's, byte for byte."""
    from mri_superresolution_torch.infer.export import load_artifact
    shutil.rmtree(ART_DIR, ignore_errors=True)
    ART_DIR.mkdir(parents=True)
    retrain = _train_cli(ART_DIR / "retrain", epochs=TRAIN_EPOCHS)
    again = _ckpt_digests(ART_DIR / "retrain")
    log("train_repeat", first=train_digests, again=again,
        bit_equal=again == train_digests, seconds=retrain["seconds"])
    if again != train_digests:
        raise AssertionError(f"the train CLI from one seed and data gave "
                             f"other checkpoints: {train_digests} then "
                             f"{again}")

    t_phase = time.perf_counter()
    # the engines' outputs on the same checkpoints, while the exports run
    # (they trace on the host)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    exporting = _export_all(qat_final)
    vol_ck = InferConfig(checkpoint_dir=str(VOL_DIR / "ckpt"))
    plain_eng = load_engine(vol_ck, device=dev)
    int8_eng = load_engine(InferConfig(checkpoint_path=qat_final,
                                       quant="int8"), device=dev)
    raw = np.ascontiguousarray(nifti.load(str(VOL_DIR / "vol.nii"),
                                          raw=True)[0].T[:BATCH])
    engines = {
        "plain.phantom": (plain_eng, lr),
        "plain.phantom_192": (plain_eng, np.ascontiguousarray(
            lr[:, :, :NONSQ_W])),
        "tta.phantom": (load_engine(dataclasses.replace(vol_ck, tta=True),
                                    device=dev), lr),
        "raw.raw": (load_engine(dataclasses.replace(
            vol_ck, normalize_inputs=True, transpose_io=True,
            out_dtype="int16"), device=dev), raw),
        "int8.phantom": (int8_eng, lr),
        "int8.black": (int8_eng, np.zeros_like(lr))}
    engine_outs = {k: eng.upscale_batch(x) for k, (eng, x) in
                   engines.items()}
    exported = exporting()
    arts = {m: exported[m]["path"] for m in ART_MODES}

    # a fresh process loads and serves each; the daemon starts beside it
    daemon = _start_artifact_daemon(arts["plain"])
    try:
        spec = {"batch": BATCH, "size": LR, "width": NONSQ_W,
                "volume": str(VOL_DIR / "vol.nii"),
                "out": str(ART_DIR / "outs.npz"),
                "artifacts": [[m, arts[m], list(ART_MODES[m][2])]
                              for m in ART_MODES]}
        r = subprocess.run([sys.executable, "-c", ARTIFACT_CLIENT,
                            json.dumps(spec)], cwd=str(ART_DIR), env=env,
                           capture_output=True, text=True, timeout=600)
        if r.returncode:
            raise AssertionError(f"artifact loader: {r.stderr[-3000:]}")
        fresh = json.loads(r.stdout.strip().splitlines()[-1])
        outs = dict(np.load(ART_DIR / "outs.npz"))
        equal = {k: bool(np.array_equal(outs[k], engine_outs[k]))
                 for k in engines}
        res = fresh["artifacts"]
        launches = {f"{m}.{b}": res[m][b]["launches"]
                    for m in ART_MODES for b in ART_MODES[m][2]}
        want = {"plain.phantom": ART_LAUNCHES["plain"],
                "plain.phantom_192": ART_LAUNCHES["plain"],
                "int8.phantom": ART_LAUNCHES["int8"],
                # a black batch routes to the plain fallback
                "int8.black": ART_LAUNCHES["plain"],
                "tta.phantom": {k: 8 * v for k, v in
                                ART_LAUNCHES["plain"].items()},
                "raw.raw": ART_LAUNCHES["plain"]}
        ok = all(equal.values()) and launches == want and \
            not fresh["model_modules"]
        log("artifact_export", **{
            m: {k: exported[m][k] for k in ("seconds", "mib", "line")}
            for m in ART_MODES})
        log("artifact_serve", same_bits_as_engine=equal, launches=launches,
            expected=want, model_modules=fresh["model_modules"],
            load_s={m: res[m]["load_s"] for m in ART_MODES},
            first_call_ms={k: res[m][b]["first_call_ms"] for m in ART_MODES
                           for b in ART_MODES[m][2]
                           for k in [f"{m}.{b}"]}, ok=ok)
        if not ok:
            raise AssertionError(f"artifacts: bits {equal}, launches "
                                 f"{launches} (want {want}), model modules "
                                 f"{fresh['model_modules']}")

        plain = load_artifact(arts["plain"], device=dev)
        int8 = load_artifact(arts["int8"], device=dev)
        kernels.reset_launch_counts()
        plain.upscale_batch(lr)
        int8.upscale_batch(lr)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        volume = _serve_volume([
            "--input", str(VOL_DIR / "vol.nii"), "--output",
            str(ART_DIR / "sr_raw.nii"), "--artifact", arts["raw"],
            "--batch_size", str(VOL_BATCH), "--serve_raw", "--out_dtype",
            "int16"])
        batches = -(-VOL_SLICES // VOL_BATCH)
        vol_want = {k: v * batches for k, v in ART_LAUNCHES["plain"].items()}
        same = bool(np.array_equal(
            nifti.load(str(ART_DIR / "sr_raw.nii"), raw=True)[0],
            nifti.load(str(VOL_DIR / "sr_b.nii"), raw=True)[0]))
        log("artifact_volume", rc=volume["rc"], seconds=volume["seconds"],
            launches=volume["launches"], expected=vol_want,
            voxel_equal_to_checkpoint_run=same)
        if volume["rc"] or not same or volume["launches"] != vol_want:
            raise AssertionError(f"infer_volume --artifact: {volume}, voxel "
                                 f"equal {same}")
        for k, v in volume["launches"].items():
            counts[k] += v
        rates = _rates({"engine": plain_eng.upscale_batch,
                        "artifact": plain.upscale_batch}, lr)
        log("artifact_throughput", slices=BATCH, hw=LR, iters=ART_RATE_ITERS,
            slices_per_s=rates, dtype="bf16")
        _artifact_daemon(*daemon, lr, hr, np.concatenate(
            [plain.upscale_batch(lr[:4]), plain.upscale_batch(lr[4:5])]))
    finally:
        if daemon[0].poll() is None:      # a failure before the daemon's leg
            daemon[0].kill()
            daemon[0].wait(30)

    cpu_art = load_artifact(arts["plain"], device="cpu")
    got = cpu_art.upscale_batch(lr[:2])
    cpu = load_engine(vol_ck, device="cpu").upscale_batch(lr[:2])
    d = _budget_quiet(_quality(got, hr[:2]), _quality(cpu, hr[:2]))
    log("artifact_cpu_vs_cpu_port", bit_equal=bool(np.array_equal(got, cpu)),
        **d)
    if not d["ok"]:
        raise AssertionError(f"the card-made artifact on the CPU: {d}")
    log("artifact_path", launches={k: v for k, v in counts.items() if v},
        seconds=time.perf_counter() - t_phase)
    return {"launches": counts}


def b1_c64_check(shape, dev, gen) -> tuple:
    """B1 at one of unet_tpu's final-stage shapes through the wrapper, on
    the route its plan gives (logged, not assumed), against the plain
    version with check_b1's gate and run to run; and the two-pass kernel
    too where the plan takes the one-pass route (``b1_check``). ((x,
    gamma, beta), route, max abs error)."""
    x, g, b = b1_inputs(shape, dev, gen)
    plan = onepass_plan(x, torch.empty_like(x))
    before = group_norm_leaky.onepass_launches
    got = group_norm_leaky(x, g, b)
    onepass = group_norm_leaky.onepass_launches - before
    ok, err = within(got, group_norm_leaky_plain(x, g, b), BF16_RTOL, 1e-5)
    same = torch.equal(got, group_norm_leaky(x, g, b))
    route = "onepass" if onepass else "twopass"
    log("kernel_check", kernel="B1", route=route, shape=list(shape),
        served_by="unet_tpu's final stage", dtype="bf16",
        plan=None if plan is None else plan._asdict(),
        onepass_launches=onepass, max_abs_err=err, rtol=BF16_RTOL,
        atol=1e-5, run_to_run_equal=same, ok=ok)
    if not (ok and same) or (plan is not None) != bool(onepass):
        raise AssertionError(f"B1 at {shape}: max abs err {err}, run to "
                             f"run equal {same}, route {route}, plan {plan}")
    if plan is not None:
        err = max(err, b1_check(x, g, b, "unet_tpu's final stage"))
    return (x, g, b), route, err


def check_b1_c64(dev, gen) -> dict:
    """B1 at unet_tpu's three final-stage sites (C = 64 at the input
    resolution): the forward at the serving, training and volume batches
    (``b1_c64_check``), the backward at the training batch (8, 64,
    128^2), each against its plain version with check_b1's and
    check_b1_backward's gates and run to run, through the wrapper, on the
    route its plan gives (logged, not assumed; the other route is checked
    too where the plan takes the shape); then L2-cold times of the
    forward at the serving batch and of the backward beside the plain
    version, the library's and the other route, with the bound. The routes by batch
    are returned for the zoo phase's launch counts."""
    routes, worst = {}, 0.0
    for shape in C64_FWD[1:]:
        _, routes[shape[0]], err = b1_c64_check(shape, dev, gen)
        worst = max(worst, err)
    (x, g, b), route, err = b1_c64_check(C64_FWD[0], dev, gen)
    routes[BATCH] = route
    err = max(worst, err)
    gb, bb = g.to(torch.bfloat16), b.to(torch.bfloat16)
    xs = l2_cold_copies(x)
    k = cuda_ms_cold(lambda t: group_norm_leaky(t, g, b), xs)
    two = cuda_ms_cold(lambda t: group_norm_leaky_twopass(t, g, b), xs)
    p = cuda_ms_cold(lambda t: group_norm_leaky_plain(t, g, b), xs)
    lib = cuda_ms_cold(
        lambda t: F.leaky_relu(F.group_norm(t, 8, gb, bb), 0.2), xs)
    del xs
    bnd, by = bound_ms(2 * x.numel() * x.element_size(), 10 * x.numel(),
                       torch.bfloat16)
    fwd = {"shape": list(C64_FWD[0]), "route": route, "sites": 3, "ms": k,
           "twopass_ms": two, "plain_ms": p, "library_ms": lib,
           "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
           "routes_by_batch": routes}
    log("kernel_time", kernel="B1", **fwd, bound_share=bnd / k,
        timing="L2-cold, CUDA graph replays")
    del x

    bsz = C64_BWD[0]
    xg, gam, bet = _bwd_inputs(C64_BWD, dev, gen)
    xb, gy = xg[:bsz], xg[bsz:]
    plan = onepass_backward_plan(xb, gy, torch.empty_like(xb))
    want = group_norm_leaky_backward_plain(xb, gam, bet, gy)
    before = group_norm_leaky_backward.onepass_launches
    got = group_norm_leaky_backward(xb, gam, bet, gy)
    onepass = group_norm_leaky_backward.onepass_launches - before
    ok, err, err_s, err_b = _b1_bwd_gates(got, want)
    same = all(torch.equal(u, v) for u, v in zip(
        got, group_norm_leaky_backward(xb, gam, bet, gy)))
    route = "onepass" if onepass else "fourpass"
    checks = {route: ok}
    if plan is not None:
        four = group_norm_leaky_backward_fourpass(xb, gam, bet, gy)
        checks["fourpass"] = _b1_bwd_gates(four, want)[0]
        del four
    log("kernel_check", kernel="B1 backward", route=route,
        shape=list(C64_BWD), served_by="unet_tpu's final stage, training",
        dtype="bf16", plan=None if plan is None else plan._asdict(),
        onepass_launches=onepass, max_abs_err_dx=err,
        max_abs_err_dscale=err_s, max_abs_err_dbias=err_b,
        routes_within_gates=checks, run_to_run_equal=same, ok=ok)
    if not (all(checks.values()) and same) or \
            (plan is not None) != bool(onepass):
        raise AssertionError(f"B1 backward at {C64_BWD}: dx {err}, dscale "
                             f"{err_s}, dbias {err_b}, routes {checks}, run "
                             f"to run {same}, plan {plan}")
    del got, want
    k, four, p, lib = _b1_bwd_times(xg, gam, bet, bsz, dev)
    bnd, by = b1_bwd_bound(xb)
    bwd = {"shape": list(C64_BWD), "route": route, "sites": 3, "ms": k,
           "fourpass_ms": four, "plain_ms": p, "library_ms": lib,
           "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
    log("kernel_time", kernel="B1 backward", **bwd, bound_share=bnd / k,
        timing="L2-cold, CUDA graph replays")
    for name, r in (("B1", fwd), ("B1 backward", bwd)):
        below = [key for key in ("ms", "plain_ms", "library_ms",
                                 "twopass_ms", "fourpass_ms")
                 if key in r and r[key] < r["bound_ms"]]
        if below:
            raise AssertionError(f"{name} times below their bound at "
                                 f"{r['shape']}: {below}")
    return {"forward": fwd, "backward": bwd}


def _zoo_want(family: str, int8: bool) -> dict:
    """The launches of one forward of ``family``, bf16 or int8."""
    want = dict.fromkeys(kernels.launch_counts(), 0)
    want.update(ZOO_INT8_LAUNCHES[family] if int8
                else ZOO_BF16_LAUNCHES[family])
    return want


def _zoo_onepass(family: str, int8: bool, batch: int, c64: dict) -> int:
    """B1's one-pass launches in one forward of ``family`` at ``batch``:
    unet_tpu's backbone sites (17; 10 in int8, where ``gn_quantize`` takes
    each conv2's GroupNorm), which check_b1 holds to the one-pass route,
    and its three C = 64 sites where check_b1_c64 found that route."""
    if family != "unet_tpu":
        return 0
    c64_onepass = c64["forward"]["routes_by_batch"][batch] == "onepass"
    return (10 if int8 else 17) + 3 * c64_onepass


def _zoo_bwd_onepass(family: str, c64: dict) -> int:
    """B1's one-pass backward launches in one training step of
    ``family``: unet_tpu's 17 backbone sites (the unet's, which
    check_b1_backward holds to that route) and its three C = 64 sites
    where check_b1_c64 found it."""
    if family != "unet_tpu":
        return 0
    return 17 + 3 * (c64["backward"]["route"] == "onepass")


def _counted(fn) -> tuple:
    """``fn()``'s result and its launches, the counts set to 0 just before
    and read just after; B1's and B4's routes apart."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts(), {
        "group_norm_leaky.onepass": group_norm_leaky.onepass_launches,
        "leaky_quantize.stream": leaky_quantize.stream_launches}


def _zoo_train(family: str, c64: dict) -> tuple:
    """The train CLI for one epoch of ``family`` at full width on the
    training phase's phantom PNGs, with its exact launches and B1's
    one-pass ones, forward and backward; (final checkpoint, launches,
    routes)."""
    gn = ZOO_BF16_LAUNCHES[family].get("group_norm_leaky", 0)
    run = _train_cli(ZOO_DIR / f"ckpt_{family}",
                     ["--model_type", family, "--num_blocks",
                      str(EDSR_BLOCKS)], gn=gn, b3=0)
    counts, steps, vals = run["launches"], run["steps"], run["vals"]
    routes = {"group_norm_leaky.onepass": run["onepass"],
              "group_norm_leaky_backward.onepass": run["backward_onepass"]}
    want_routes = {
        "group_norm_leaky.onepass": (steps + vals) * _zoo_onepass(
            family, False, TRAIN_BATCH, c64),
        "group_norm_leaky_backward.onepass": steps * _zoo_bwd_onepass(
            family, c64)}
    summaries = run["by_type"].get("epoch_summary", [])
    sd = ckpt.load_checkpoint(run["final"])[0]
    log("zoo_train", family=family, steps=steps, val_batches=vals,
        seconds=run["seconds"], launches=counts, routes=routes,
        expected=run["expected"], expected_routes=want_routes,
        epoch_summaries=summaries, checkpoint=run["final"],
        params=sum(v.numel() for v in sd.values()))
    losses = [x for s in summaries for x in (s["train_loss"], s["val_loss"])]
    if counts != run["expected"] or routes != want_routes or \
            len(summaries) != 1 or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"{family} training: launches {counts}, "
                             f"expected {run['expected']}; routes {routes}, "
                             f"expected {want_routes}; summaries "
                             f"{summaries}")
    return run["final"], counts, routes


def _zoo_step(family: str, dev, c64: dict) -> dict:
    """One bf16 training step of ``family`` at batch 8 of 128^2 -> 256^2
    counted alone, then its time (CUDA events, 10 steps after 2)."""
    model = build_model(ModelConfig(model_type=family,
                                    base_filters=BASE_FILTERS,
                                    num_blocks=EDSR_BLOCKS),
                        dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(
                            TRAIN_SEED)).to(dev)
    state = trainer.TrainState(model, trainer.make_optimizer(
        model.parameters(), 1e-4, 1e-5))
    step = trainer.build_train_step(CombinedLoss(LossConfig()))
    batch = _train_batch(dev, TRAIN_BATCH, TRAIN_LR)
    per_step = _step_counts(lambda: step(state, batch, 1e-4))
    gn = ZOO_BF16_LAUNCHES[family].get("group_norm_leaky", 0)
    want = {"ssim_per_sample": 1}
    if gn:
        want.update(group_norm_leaky=gn, group_norm_leaky_backward=gn)
    if _zoo_bwd_onepass(family, c64):
        want["group_norm_leaky_backward.onepass"] = _zoo_bwd_onepass(
            family, c64)
    ms = cuda_ms(lambda: step(state, batch, 1e-4), iters=STEP_ITERS,
                 warmup=2)
    log("zoo_train_step", family=family, launches=per_step, expected=want,
        step_ms=ms, slices_per_s=TRAIN_BATCH / ms * 1e3,
        timing="CUDA events around 10 steps after 2 warm-up steps")
    if per_step != want:
        raise AssertionError(f"{family} step launches {per_step}, "
                             f"expected {want}")
    return {"step_ms": ms, "launches": per_step}


def _volume_slices(vol: Path) -> tuple:
    """A volume's (slices, H, W) stack as stored, and its slices
    ``VOL_CPU_SLICES`` normalized as the CLI does, for the CPU port."""
    data, _ = nifti.load(str(vol))
    stack = np.ascontiguousarray(np.transpose(data, (2, 0, 1))).astype(
        np.float32)
    return stack, normalize_slices(
        torch.from_numpy(stack[VOL_CPU_SLICES])).numpy()


def _zoo_volume_want(family: str, key: str, c64: dict) -> tuple:
    """(launches, B1 one-pass launches) of the infer_volume CLI's run of
    ``family`` at batch 32: bf16, every batch's forward; int8, the first
    batch's calibration forward (the bf16 one), then every batch int8
    (the first re-served once its scales freeze)."""
    batches = -(-VOL_SLICES // VOL_BATCH)
    bf16, int8 = ZOO_BF16_LAUNCHES[family], ZOO_INT8_LAUNCHES[family]
    one = _zoo_onepass(family, False, VOL_BATCH, c64)
    if key == "bf16":
        return {k: batches * v for k, v in bf16.items()}, batches * one
    return ({k: bf16.get(k, 0) + batches * int8.get(k, 0)
             for k in {**bf16, **int8}},
            one + batches * _zoo_onepass(family, True, VOL_BATCH, c64))


def _zoo_serve(family: str, final: str, dev, lr, hr, c64: dict) -> dict:
    """The family's checkpoint served: the infer_volume CLI on the volume
    phase's phantom volume (defaults, then ``--quant int8`` writing its
    frozen scales) with its exact launches and B1's and B4's routes; 16
    slices of 256^2 through ``upscale_batch`` in bf16 and int8 (those
    scales), launches counted a forward, slices/s in turns; the card
    against the CPU port at the bf16 budget, int8 with the same frozen
    scales: on 2 of the 16 slices, and on slices 48-49 of each volume."""
    scales = ZOO_DIR / f"scales_{family}.json"
    scales.unlink(missing_ok=True)
    truth = phantom_batch(np.random.default_rng(VOL_SEED), VOL_SLICES,
                          2 * VOL_HW)[VOL_CPU_SLICES]
    common = ["--input", str(VOL_DIR / "vol.nii"), "--checkpoint_dir",
              str(Path(final).parent), "--model_type", family,
              "--batch_size", str(VOL_BATCH)]
    vol, vol_out = {}, {}
    for key, flags in (("bf16", []),
                       ("int8", ["--quant", "int8", "--quant_calib",
                                 str(scales), "--quant_calib_slices",
                                 str(VOL_BATCH)])):
        out = ZOO_DIR / f"sr_{family}_{key}.nii"
        r = _serve_volume([*common, "--output", str(out), *flags])
        r["stream_launches"] = leaky_quantize.stream_launches
        vol_out[key] = _read_volume(out, 1.0)[VOL_CPU_SLICES]
        want, onepass = _zoo_volume_want(family, key, c64)
        vol[key] = r
        log("zoo_volume", family=family, run=key, flags=flags,
            expected_launches=want, expected_onepass=onepass, **r)
        ok = r["rc"] == 0 and r["launches"] == want and \
            r["onepass_launches"] == onepass and \
            r["stream_launches"] == want.get("leaky_quantize", 0) and \
            (key == "bf16" or scales.exists())
        if not ok:
            raise AssertionError(f"{family} volume ({key}): exit {r['rc']}, "
                                 f"launches {r['launches']} (B1 one-pass "
                                 f"{r['onepass_launches']}, B4 stream "
                                 f"{r['stream_launches']}), expected {want} "
                                 f"({onepass}); sidecar {scales.exists()}")

    cfg = InferConfig(checkpoint_path=final)
    bf16 = load_engine(cfg, device=dev)
    int8 = load_engine(dataclasses.replace(
        cfg, quant="int8", quant_calib_path=str(scales)), device=dev)
    names = [s for s, _ in quant_forward.quant_sites(int8._params, family)]
    if names != [s for s, _, _ in zoo_quant_sites(family, BATCH, LR,
                                                  BASE_FILTERS)]:
        raise AssertionError(f"zoo_quant_sites does not list {family}'s "
                             f"int8 sites {names}")
    res = {"volume": vol}
    outs = {}
    for key, eng in (("bf16", bf16), ("int8", int8)):
        eng.upscale_batch(lr[:2])                         # warm
        out, counts, routes = _counted(lambda: eng.upscale_batch(lr))
        want = _zoo_want(family, key == "int8")
        want_routes = {
            "group_norm_leaky.onepass": _zoo_onepass(family, key == "int8",
                                                     BATCH, c64),
            "leaky_quantize.stream": want["leaky_quantize"]}
        outs[key] = out
        log("zoo_launches", family=family, precision=key, slices=BATCH,
            launches=counts, routes=routes, expected=want,
            expected_routes=want_routes)
        if counts != want or routes != want_routes:
            raise AssertionError(f"{family} {key} forward launches {counts},"
                                 f" expected {want}; routes {routes}, "
                                 f"expected {want_routes}")
        if out.shape != (BATCH, 2 * LR, 2 * LR) or \
                not np.isfinite(out).all() or out.min() < 0 or out.max() > 1:
            raise AssertionError(f"{family} {key}: bad output {out.shape}")
        res[key] = {"launches": counts, "routes": routes}
    if int8._quant_batches["bf16"] or int8.quant_calibrating:
        raise AssertionError(f"{family} int8 engine: {int8.quant_summary()}")

    # serving rates in turns, and peak memory of the two engines
    torch.cuda.reset_peak_memory_stats()
    t = {"bf16": [], "int8": []}
    for key in ("bf16", "int8", "int8", "bf16"):
        eng = bf16 if key == "bf16" else int8
        t[key].append(cuda_ms(lambda: eng.upscale_batch(lr), iters=10,
                              warmup=2))
    for key, v in t.items():
        res[key]["ms_per_batch"] = v
        res[key]["slices_per_s"] = BATCH / (sum(v) / len(v)) * 1e3
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("zoo_throughput", family=family, batch=BATCH,
        slices_per_s={k: res[k]["slices_per_s"] for k in ("bf16", "int8")},
        ms_per_batch=t, peak_mem_gb=res["peak_mem_gb"],
        timing="CUDA events around 10 upscale_batch calls after 2, host "
               "batch in and out, in turns bf16, int8, int8, bf16")

    # the CPU port, int8 with the card's frozen scales: 2 of the 16
    # slices, then slices 48-49 of the volume
    norm = _volume_slices(VOL_DIR / "vol.nii")[1]
    for key, kw in (("bf16", {}), ("int8", {"quant": "int8",
                                           "quant_calib_path": str(scales)})):
        cpu = load_engine(dataclasses.replace(cfg, **kw), device="cpu")
        out_cpu = cpu.upscale_batch(lr[:2])
        g, c = _quality(outs[key][:2], hr[:2]), _quality(out_cpu, hr[:2])
        d = {"d_psnr_db": abs(g["psnr_db"] - c["psnr_db"]),
             "d_ssim": abs(g["ssim"] - c["ssim"])}
        d["ok"] = d["d_psnr_db"] <= 0.1 and d["d_ssim"] <= 1e-3
        log("zoo_cpu_vs_gpu", family=family, precision=key, slices=2,
            card=g, cpu=c, max_abs_diff=float(np.abs(
                outs[key][:2] - out_cpu).max()), **d)
        if not d["ok"]:
            raise AssertionError(f"{family} {key}: the card and the CPU "
                                 f"port differ beyond the bf16 budget {d}")
        res[key]["cpu_vs_gpu"] = d
        if key == "bf16" and family in ZOO_ALL_SLICES:
            res[key]["cpu_vs_gpu_all"] = _zoo_all_slices(
                family, cfg, cpu, outs[key], lr, hr)
        vol[key]["cpu_vs_gpu"] = _budget(
            f"{family} volume ({key}) slices {VOL_CPU_SLICES.start}-"
            f"{VOL_CPU_SLICES.stop - 1} against the CPU port",
            _quality(vol_out[key], truth, dev),
            _quality(cpu.upscale_batch(norm), truth, dev))
        if key == "int8" and cpu._quant_batches != {"int8": 2, "bf16": 0}:
            raise AssertionError(f"the CPU port's int8 engine: "
                                 f"{cpu.quant_summary()}")
    return res


def _zoo_all_slices(family: str, cfg, cpu, out: np.ndarray,
                    lr: np.ndarray, hr: np.ndarray) -> dict:
    """All the serving batch's slices, card against the CPU port, bf16:
    the 16 together at the bf16 budget, and each slice alone, its |dSSIM|
    (against one truth) within ``ZOO_SLICE_SSIM_FLOOR`` or
    ``ZOO_SLICE_CONTROL_FACTOR`` times a control on the same slice, the
    CPU port's bf16 against its fp32, whichever is larger: one slice's
    SSIM moves more under bf16's rounding than the budget allows (the
    control breaks 1e-3 alone on some slices), and the card sums in
    another order than the CPU. Both numbers are logged a slice."""
    out_cpu = cpu.upscale_batch(lr)
    fp32 = load_engine(dataclasses.replace(cfg, bf16=False),
                       device="cpu").upscale_batch(lr)
    one = lambda a, i: _quality(a[i:i + 1], hr[i:i + 1])  # noqa: E731
    per = [_budget_quiet(one(out, i), one(out_cpu, i))
           for i in range(len(lr))]
    control = [_budget_quiet(one(out_cpu, i), one(fp32, i))
               for i in range(len(lr))]
    limits = [max(ZOO_SLICE_SSIM_FLOOR,
                  ZOO_SLICE_CONTROL_FACTOR * c["d_ssim"]) for c in control]
    over = [i for i, (d, lim) in enumerate(zip(per, limits))
            if d["d_ssim"] > lim]
    whole = _budget_quiet(_quality(out, hr), _quality(out_cpu, hr))
    worst = {k: max(d[k] for d in per) for k in ("d_psnr_db", "d_ssim")}
    ratios = [d["d_ssim"] / c["d_ssim"] if c["d_ssim"] > 0 else None
              for d, c in zip(per, control)]
    ok = whole["ok"] and not over
    log("zoo_cpu_vs_gpu_all_slices", family=family, precision="bf16",
        slices=len(lr), whole_batch=whole, worst_slice=worst,
        d_ssim=[d["d_ssim"] for d in per],
        control_cpu_bf16_vs_fp32_d_ssim=[d["d_ssim"] for d in control],
        slice_limit=limits, ratio_to_control=ratios,
        d_psnr_db=[d["d_psnr_db"] for d in per],
        slices_beyond_limit=over,
        slices_beyond_budget=[i for i, d in enumerate(per) if not d["ok"]],
        control_slices_beyond_budget=[i for i, d in enumerate(control)
                                      if not d["ok"]], ok=ok)
    if not ok:
        raise AssertionError(f"{family} bf16 against the CPU port: the 16 "
                             f"slices {whole}, slices beyond their limit "
                             f"{over}")
    return {"whole_batch": whole, "worst_slice": worst,
            "slices_beyond_limit": over,
            "slices_beyond_budget": [i for i, d in enumerate(per)
                                     if not d["ok"]]}


def zoo_path(dev, lr, hr, c64: dict) -> dict:
    """The other three families through their entry points, at full width
    (base filters 32, edsr 8 blocks), seeded init: the train CLI for one
    epoch writes each family's checkpoint, which the infer_volume CLI and
    the engine then serve in bf16 and int8; each family's training step
    counted and timed. B1's routes are expected as check_b1_c64 found
    them (``c64``). The launch counts of the whole phase are returned for
    the kernels line."""
    shutil.rmtree(ZOO_DIR, ignore_errors=True)
    ZOO_DIR.mkdir(parents=True)
    res, totals = {}, dict.fromkeys(kernels.launch_counts(), 0)
    for family in ZOO_FAMILIES:
        final, train_counts, train_routes = _zoo_train(family, c64)
        serve = _zoo_serve(family, final, dev, lr, hr, c64)
        res[family] = {"train": {"launches": train_counts,
                                 "routes": train_routes},
                       "serve": serve, "step": _zoo_step(family, dev, c64)}
        # the phase's counted runs: training, the two volume runs and
        # one forward in each precision
        for counts in (train_counts, serve["volume"]["bf16"]["launches"],
                       serve["volume"]["int8"]["launches"],
                       serve["bf16"]["launches"], serve["int8"]["launches"]):
            for k, v in counts.items():
                totals[k] += v
    log("zoo_path", families=list(ZOO_FAMILIES), launches=totals)
    return {"results": res, "launches": totals}


def _write_extract_volumes() -> dict:
    """The extraction phase's volumes: ``quality.make_volume`` anatomy at
    ``EXTRACT_SHAPE`` stored int16 under scl_slope ``EXTRACT_SLOPE``, the
    even ones as .nii and the odd ones as .nii.gz, in a BIDS tree a
    split; the datasets folder by split."""
    rng = np.random.default_rng(EXTRACT_SEED)
    roots, i = {}, 0
    for split, n in EXTRACT_VOLUMES.items():
        roots[split] = EXTRACT_DIR / f"data_{split}"
        for _ in range(n):
            anat = roots[split] / f"set1/sub-{i:02d}/anat"
            anat.mkdir(parents=True)
            stored = np.round(quality.make_volume(rng, EXTRACT_SHAPE)
                              / EXTRACT_SLOPE).astype(np.int16)
            nifti.save(str(anat / f"sub-{i:02d}_T1w.nii{'.gz' * (i % 2)}"),
                       stored, zooms=(0.9, 0.9, 1.0),
                       scl_slope=EXTRACT_SLOPE)
            i += 1
    return roots


def _extract_cli(data: Path, split: str, out: str = None,
                 stage_times: bool = True) -> dict:
    """One in-process run of the extract CLI on the card over ``data``
    (``split``'s volumes), writing EXTRACT_DIR/hr_<out> and lr_<out>
    (``out`` defaults to ``split``), with ``--stage_times`` if asked; its
    summary (stage ms, slices, seconds), with its wall time and the
    checked outputs."""
    out_name = out or split
    argv = ["--datasets_dir", str(data),
            "--hr_output_dir", str(EXTRACT_DIR / f"hr_{out_name}"),
            "--lr_output_dir", str(EXTRACT_DIR / f"lr_{out_name}"),
            "--n_slices", str(EXTRACT_SLICES), "--target_size",
            str(EXTRACT_TARGET), str(EXTRACT_TARGET),
            "--seed", str(EXTRACT_SEED)] + ["--stage_times"] * stage_times
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res = extract_cli.run(extract_cli.parse_args(argv))
    res["wall_s"] = time.perf_counter() - t0
    hr = sorted(p.name for p in (EXTRACT_DIR / f"hr_{out_name}").iterdir())
    lr = sorted(p.name for p in (EXTRACT_DIR / f"lr_{out_name}").iterdir())
    n = EXTRACT_VOLUMES[split] * EXTRACT_SLICES
    sizes = {native.png_size(str(EXTRACT_DIR / f"{d}_{out_name}" / hr[0]))
             for d in ("hr", "lr")}
    log("extract_cli", split=split, out=out_name, stage_times=stage_times,
        rc=res["rc"], files=res["files"],
        failed=res["failed"], slices=res["slices"], seconds=res["seconds"],
        wall_s=res["wall_s"], stage_ms=res["stage_ms"],
        slices_per_s=res["slices"] / res["wall_s"], png_sizes=sorted(sizes),
        last_line=printed.getvalue().splitlines()[-1])
    want_sizes = {(EXTRACT_TARGET, EXTRACT_TARGET),
                  (EXTRACT_TARGET // 2, EXTRACT_TARGET // 2)}
    if res["rc"] != 0 or res["slices"] != n or hr != lr or len(hr) != n \
            or sizes != want_sizes:
        raise AssertionError(f"extract CLI ({split}): rc {res['rc']}, "
                             f"{res['slices']} slices of {n}, {len(hr)} HR "
                             f"and {len(lr)} LR files, sizes {sizes}")
    return res


def _extract_card_vs_cpu(data: Path, split: str, dev) -> dict:
    """The card's PNGs of ``split`` against the CPU port's pipelines on
    the same volumes and the same noise (the card's draws, fetched):
    codes identical on at least CODES_SAME_MIN of the pixels, none more
    than CODES_DIFF_MAX apart, HR and LR apart."""
    diffs = {"hr": [], "lr": []}
    size = (EXTRACT_TARGET, EXTRACT_TARGET)
    for i, path in enumerate(find_nifti_files(str(data))):
        stored, hdr = nifti.load_stored(path)
        idx, stack = pick_slices(stored, EXTRACT_SLICES, 0.2, 0.8, hdr)
        x = torch.from_numpy(stack)
        noise = draw_kspace_noise(tuple(x.shape), torch.Generator(
            device=dev).manual_seed(sub_seed(EXTRACT_SEED, i)))
        cpu = {"hr": hr_pipeline(x, size).numpy(),
               "lr": lr_pipeline(x, tuple(n.cpu() for n in noise),
                                 size).numpy()}
        subject = generate_bids_identifier(path)
        for key, imgs in cpu.items():
            for j, z in enumerate(idx):
                png = native.imread_gray(str(
                    EXTRACT_DIR / f"{key}_{split}" /
                    generate_filename(subject, int(z))))
                diffs[key].append(np.abs(png.astype(np.int16) - to_uint8(
                    imgs[j]).astype(np.int16)))
    res = {}
    for key, d in diffs.items():
        d = np.stack(d)
        res[key] = {"pixels": int(d.size),
                    "same_share": float((d == 0).mean()),
                    "max_code_diff": int(d.max())}
    ok = all(r["same_share"] >= CODES_SAME_MIN and
             r["max_code_diff"] <= CODES_DIFF_MAX for r in res.values())
    log("extract_cpu_vs_gpu", split=split, volumes=EXTRACT_VOLUMES[split],
        **res, ok=ok)
    if not ok:
        raise AssertionError(f"extraction on the card against the CPU port "
                             f"({split}): {res}")
    return res


def _add(totals: dict, counts: dict) -> None:
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v


def extract_path(dev) -> dict:
    """Paired-slice extraction through its entry point, then the unet
    trained and served on what it made: 8 int16 volumes (6 train, 2 test)
    through the extract CLI on the card, with its stages' ms
    (``--stage_times``) and slices/s; the test split again without it
    (slices/s, the same PNG bytes); one volume traced (host against
    device time); the test split's
    PNGs against the CPU port on the card's noise draws; the train CLI at
    full width and the JAX package's defaults for EXTRACT_EPOCHS epochs
    (the train loss must fall); the final checkpoint served over the 50
    held-out pairs in bf16, int8 PTQ (scales calibrated on 8
    content-rich train-split slices) and TTA, beside the three baselines
    (``tools/quality.py``);
    bf16 and int8 on the card against the CPU port at the bf16 budget on
    2 pairs with content, int8 with the card's frozen scales; bf16 on the
    black pairs on max abs difference against two controls
    (``BLACK_CONTROL_FACTOR``). Every launch of the phase is counted,
    train and serve segments exactly, with B1's and B4's routes."""
    start = time.perf_counter()
    shutil.rmtree(EXTRACT_DIR, ignore_errors=True)
    roots = _write_extract_volumes()
    write_s = time.perf_counter() - start
    totals = dict.fromkeys(kernels.launch_counts(), 0)

    runs = {}
    for split, data in roots.items():
        kernels.reset_launch_counts()
        runs[split] = _extract_cli(data, split)
        _add(totals, kernels.launch_counts())
    stage_ms = {k: sum(r["stage_ms"][k] for r in runs.values())
                for k in runs["train"]["stage_ms"]}
    wall = sum(r["wall_s"] for r in runs.values())
    slices = sum(r["slices"] for r in runs.values())
    # the test split again as the CLI runs by default (the card
    # synchronized only at the fetch): the same PNG bytes
    kernels.reset_launch_counts()
    plain = _extract_cli(roots["test"], "test", "test_unsynced", False)
    _add(totals, kernels.launch_counts())
    same = all((EXTRACT_DIR / f"{d}_test" / f.name).read_bytes()
               == f.read_bytes()
               for d in ("hr", "lr")
               for f in (EXTRACT_DIR / f"{d}_test_unsynced").iterdir())
    log("extract_unsynced", slices=plain["slices"], wall_s=plain["wall_s"],
        slices_per_s=plain["slices"] / plain["wall_s"],
        synced_slices_per_s=runs["test"]["slices"] / runs["test"]["wall_s"],
        same_png_bytes=same)
    if not same:
        raise AssertionError("the extract CLI wrote other PNG bytes without "
                             "--stage_times from the same seed")
    test_vol = find_nifti_files(str(roots["test"]))[0]
    scratch = EXTRACT_DIR / "traced"
    scratch.mkdir()
    traced = trace_calls(lambda: extract_from_nifti(
        test_vol, str(scratch), str(scratch), seed=1, device=dev,
        n_slices=EXTRACT_SLICES, target_size=(EXTRACT_TARGET,
                                              EXTRACT_TARGET),
        verbose=False), top=8, iters=3, warmup=1)
    log("extract_breakdown", volumes=sum(EXTRACT_VOLUMES.values()),
        volume=list(EXTRACT_SHAPE), slices=slices, wall_s=wall,
        slices_per_s=slices / wall, stage_ms=stage_ms,
        stage_share={k: v / (wall * 1e3) for k, v in stage_ms.items()},
        write_volumes_s=write_s, traced_volume=traced,
        timing="host clock; each stage ends in a synchronize "
               "(--stage_times); one .nii.gz test volume traced with "
               "torch.profiler")
    check = _extract_card_vs_cpu(roots["test"], "test", dev)

    # the unet trained on the extracted pairs
    n_train = EXTRACT_VOLUMES["train"] * EXTRACT_SLICES
    n_val = int(0.2 * n_train)
    steps = EXTRACT_EPOCHS * -(-(n_train - n_val) // TRAIN_BATCH)
    vals = EXTRACT_EPOCHS * -(-n_val // TRAIN_BATCH)
    ck = EXTRACT_DIR / "ckpt"
    argv = ["--full_res_dir", str(EXTRACT_DIR / "hr_train"),
            "--low_res_dir", str(EXTRACT_DIR / "lr_train"),
            "--base_filters", str(BASE_FILTERS),
            "--batch_size", str(TRAIN_BATCH), "--epochs",
            str(EXTRACT_EPOCHS), "--seed", str(TRAIN_SEED),
            "--checkpoint_dir", str(ck), "--log_dir", str(ck / "logs")]
    proto = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(proto):
        final = train_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = kernels.launch_counts()
    train_routes = {
        "group_norm_leaky.onepass": group_norm_leaky.onepass_launches,
        "group_norm_leaky_backward.onepass":
            group_norm_leaky_backward.onepass_launches}
    _add(totals, train_counts)
    summaries = [d for d in (json.loads(ln) for ln in
                             proto.getvalue().splitlines()
                             if ln.startswith("{"))
                 if d["type"] == "epoch_summary"]
    want = dict.fromkeys(train_counts, 0)
    want.update(group_norm_leaky=20 * (steps + vals),
                group_norm_leaky_backward=20 * steps,
                conv3x3=2 * (steps + vals), ssim_per_sample=steps + vals)
    want_routes = {
        "group_norm_leaky.onepass": want["group_norm_leaky"],
        "group_norm_leaky_backward.onepass":
            want["group_norm_leaky_backward"]}
    losses = [s["train_loss"] for s in summaries]
    log("extract_train", pairs=n_train, epochs=EXTRACT_EPOCHS, steps=steps,
        val_batches=vals, seconds=train_s, launches=train_counts,
        expected=want, routes=train_routes, expected_routes=want_routes,
        train_losses=losses, val_losses=[s["val_loss"] for s in summaries],
        checkpoint=final, pairs_sha256=_files_digest(
            EXTRACT_DIR / "hr_train", EXTRACT_DIR / "lr_train"),
        checkpoint_sha256=_ckpt_digests(ck)["final_model_unet"])
    if train_counts != want or train_routes != want_routes or \
            len(losses) != EXTRACT_EPOCHS or \
            not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training on the extracted pairs: launches "
                             f"{train_counts}, expected {want}; routes "
                             f"{train_routes}, expected {want_routes}; "
                             f"train losses {losses}")

    # the final checkpoint served over the held-out pairs
    pairs = quality.held_out_pairs(str(EXTRACT_DIR / "lr_test"),
                                   str(EXTRACT_DIR / "hr_test"))
    lrs = quality.read_pngs([a for a, _ in pairs])
    hrs = quality.read_pngs([b for _, b in pairs])
    calib = quality.read_pngs(sorted(
        str(p) for p in (EXTRACT_DIR / "lr_train").iterdir()))
    scales = EXTRACT_DIR / "int8_scales.json"
    kernels.reset_launch_counts()
    rows, outs = quality.checkpoint_rows(final, "unet", lrs, hrs, calib,
                                         dev, str(scales))
    rows.update(quality.baseline_rows(lrs, hrs, dev, rows["unet/bf16"],
                                      "unet/bf16"))
    torch.cuda.synchronize()
    serve_counts = kernels.launch_counts()
    serve_routes = {
        "group_norm_leaky.onepass": group_norm_leaky.onepass_launches,
        "leaky_quantize.stream": leaky_quantize.stream_launches}
    _add(totals, serve_counts)
    n = len(pairs)
    served = rows["unet/int8"]["served"]
    n_int8 = served["int8"]
    n_bf16 = rows["unet/int8"]["calibration_forwards"] + n - n_int8
    want = dict.fromkeys(serve_counts, 0)
    want.update(group_norm_leaky=20 * n + 13 * n_int8 + 20 * n_bf16
                + 160 * n,
                conv3x3=2 * n + 2 * n_bf16 + 16 * n, gn_quantize=7 * n_int8,
                leaky_quantize=13 * n_int8,
                ssim_per_sample=len(quality.MODES) + 3)
    # one image a forward: B1 all one-pass, B4 all on the stream route
    want_routes = {"group_norm_leaky.onepass": want["group_norm_leaky"],
                   "leaky_quantize.stream": want["leaky_quantize"]}
    log("extract_serve", pairs=n, lr=list(lrs.shape[1:]),
        hr=list(hrs.shape[1:]), rows=rows, launches=serve_counts,
        expected=want, routes=serve_routes, expected_routes=want_routes,
        scales=scales.exists())
    if serve_counts != want or serve_routes != want_routes or \
            n != EXTRACT_VOLUMES["test"] * EXTRACT_SLICES or not n_int8 \
            or not scales.exists():
        raise AssertionError(f"serving the extracted pairs: {n} pairs, "
                             f"{served} served int8/bf16, launches "
                             f"{serve_counts}, expected {want}; routes "
                             f"{serve_routes}, expected {want_routes}")
    for name, out in outs.items():
        if out.shape != hrs.shape or not np.isfinite(out).all() or \
                out.min() < 0 or out.max() > 1:
            raise AssertionError(f"{name}: bad output {out.shape}")

    # bf16 and int8 on the card against the CPU port: the first 2
    # held-out pairs with content that int8 serves (LR foreground at least
    # the engine's routing threshold; black pairs measure only the
    # output's offset from 0, where bf16 rounding moves PSNR and SSIM most)
    fg = np.abs(lrs).reshape(len(lrs), -1) > FOREGROUND_INTENSITY
    pick = np.flatnonzero(quality.content_pairs(hrs) & (
        fg.mean(axis=1) >= InferConfig().quant_min_foreground))[:2]
    gates = {}
    for mode in ("bf16", "int8"):
        cpu = quality.load_mode_engine(final, "unet", mode, "cpu",
                                       scales_path=str(scales))
        out_cpu = quality.serve(cpu, lrs[pick])
        g = quality.summarize(outs[mode][pick], hrs[pick], "cpu")
        c = quality.summarize(out_cpu, hrs[pick], "cpu")
        d = {"d_psnr_db": abs(g["psnr"] - c["psnr"]),
             "d_ssim": abs(g["ssim"] - c["ssim"])}
        d["ok"] = len(pick) == 2 and d["d_psnr_db"] <= 0.1 and \
            d["d_ssim"] <= 1e-3
        log("extract_cpu_vs_gpu", precision=mode,
            pairs=[os.path.basename(pairs[i][0]) for i in pick],
            card=g, cpu=c,
            max_abs_diff=float(np.abs(outs[mode][pick] - out_cpu).max()),
            cpu_served=dict(cpu._quant_batches), **d)
        if not d["ok"] or (mode == "int8" and cpu._quant_batches["int8"]
                           != 2):
            raise AssertionError(f"{mode}: the card and the CPU port differ "
                                 f"beyond the bf16 budget {d} "
                                 f"({cpu.quant_summary()})")
        gates[mode] = d

    # the black pairs (an empty slice's: LR all zero, where B1's groups
    # have zero variance, rstd 1/sqrt(eps)) on max abs difference, bf16 on
    # the card against the CPU port; against two controls on the same
    # pairs: the card with the port's kernels swapped for their plain
    # versions against the CPU port (what PyTorch's own CUDA ops move;
    # no kernel may launch), and the CPU port's bf16 against its fp32
    # (what the precision moves)
    black = np.flatnonzero(~quality.content_pairs(hrs))
    cpu = {m: quality.serve(quality.load_mode_engine(final, "unet", m,
                                                     "cpu"), lrs[black])
           for m in ("bf16", "fp32")}
    kernels.reset_launch_counts()
    grad_gap.use_plain_kernels(True)
    try:
        plain = quality.serve(quality.load_mode_engine(final, "unet", "bf16",
                                                       dev), lrs[black])
    finally:
        grad_gap.use_plain_kernels(False)
    torch.cuda.synchronize()
    plain_launches = sum(kernels.launch_counts().values())
    d = {"pairs": len(black),
         "max_abs_diff": float(np.abs(outs["bf16"][black]
                                      - cpu["bf16"]).max()),
         "control_plain_card_vs_cpu": float(np.abs(plain
                                                   - cpu["bf16"]).max()),
         "control_bf16_vs_fp32": float(np.abs(cpu["bf16"]
                                              - cpu["fp32"]).max()),
         "plain_control_launches": plain_launches}
    d["limit"] = BLACK_CONTROL_FACTOR * max(d["control_plain_card_vs_cpu"],
                                            d["control_bf16_vs_fp32"])
    d["ratio"] = d["max_abs_diff"] / max(d["control_plain_card_vs_cpu"],
                                         d["control_bf16_vs_fp32"])
    d["ok"] = len(black) > 0 and not lrs[black].any() and \
        plain_launches == 0 and np.isfinite(outs["bf16"][black]).all() \
        and d["max_abs_diff"] <= d["limit"]
    log("extract_black_pairs", precision="bf16",
        names=[os.path.basename(pairs[i][0]) for i in black],
        card_max=float(outs["bf16"][black].max()),
        cpu_max=float(cpu["bf16"].max()), **d)
    if not d["ok"]:
        raise AssertionError(f"the black pairs: the card and the CPU port "
                             f"differ beyond {BLACK_CONTROL_FACTOR} times "
                             f"the controls ({d})")
    gates["black"] = d
    log("extract_path", launches=totals,
        seconds=time.perf_counter() - start)
    return {"launches": totals, "extract": runs, "unsynced": plain,
            "check": check, "rows": rows, "gates": gates, "roots": roots}


@contextlib.contextmanager
def _cwd(path: Path):
    prev = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(prev)


@contextlib.contextmanager
def _fds_to(path: Path, err: Path = None):
    """This process's stdout and stderr, and its children's, into
    ``path`` (stderr into ``err`` if given) for the duration (the train
    CLI's children print their protocol lines there, not among this
    script's)."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = [os.dup(1), os.dup(2)]
    with open(path, "ab") as f, open(err or path, "ab") as e:
        os.dup2(f.fileno(), 1)
        os.dup2(e.fileno(), 2)
    try:
        yield
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(saved[0], 1)
        os.dup2(saved[1], 2)
        for fd in saved:
            os.close(fd)


def _json_lines(path: Path) -> list:
    out = []
    for ln in path.read_text(errors="replace").splitlines():
        if ln.startswith("{"):
            try:
                out.append(json.loads(ln))
            except ValueError:
                pass
    return out


def _counted_run(fn, totals: dict) -> tuple:
    """``fn()`` with every launch count set to 0 just before and read
    just after (added to ``totals``): its result, seconds, the counts,
    and B1's and B4's routes."""
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    routes = {"group_norm_leaky.onepass": group_norm_leaky.onepass_launches,
              "leaky_quantize.stream": leaky_quantize.stream_launches}
    _add(totals, counts)
    return res, seconds, counts, routes


def _eval_main(argv, engines: list):
    """``cli.evaluate.main(argv)`` with its printout captured, keeping
    each engine it loads in ``engines``."""
    made = eval_cli._load_engine_for

    def keep(*a, **k):
        engines.append(made(*a, **k))
        return engines[-1]
    eval_cli._load_engine_for = keep
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return eval_cli.main(argv)
    finally:
        eval_cli._load_engine_for = made


def _csv_rows(path: Path) -> tuple:
    import csv
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def _want(forwards_bf16: int = 0, forwards_int8: int = 0, b2: int = 0,
          keys=()) -> dict:
    """Launches of ``forwards_bf16`` bf16 unet forwards (B1 20, B3 2),
    ``forwards_int8`` int8 ones (B1 13, gn_quantize 7, B4 13) and ``b2``
    metric calls, with every other wrapper at 0."""
    want = dict.fromkeys(keys, 0)
    want.update(group_norm_leaky=20 * forwards_bf16 + 13 * forwards_int8,
                conv3x3=2 * forwards_bf16, gn_quantize=7 * forwards_int8,
                leaky_quantize=13 * forwards_int8, ssim_per_sample=b2)
    return want


def _gate(name: str, counts: dict, want: dict, routes: dict,
          extra_ok: bool = True, **fields) -> None:
    want_routes = {"group_norm_leaky.onepass": want["group_norm_leaky"],
                   "leaky_quantize.stream": want["leaky_quantize"]}
    ok = counts == want and routes == want_routes and extra_ok
    log(name, launches=counts, expected=want, routes=routes,
        expected_routes=want_routes, ok=ok, **fields)
    if not ok:
        raise AssertionError(f"{name}: launches {counts}, expected {want}; "
                             f"routes {routes}, expected {want_routes}; "
                             f"{fields}")


def _png_hw(path) -> tuple:
    return tuple(native.imread_gray(str(path)).shape)


def _median_ms(rows: list) -> dict:
    return {m: float(np.median([float(r["time"]) for r in rows
                                if r["method"] == m])) * 1e3
            for m in EVAL_METHODS}


def _copy_pairs(names, root: Path) -> tuple:
    for d in ("hr", "lr"):
        (root / d).mkdir(parents=True)
        for n in names:
            shutil.copy(EXTRACT_DIR / f"{d}_test" / n, root / d / n)
    return str(root / "hr"), str(root / "lr")


def _tui_renders() -> dict:
    """``python -m mri_superresolution_torch.cli.ui`` under a pty: its main
    menu rendered, then ``q``; the seconds to the menu and the exit."""
    import pty
    import select
    t0 = time.perf_counter()
    pid, fd = pty.fork()
    if pid == 0:
        env = dict(child_env(), TERM="xterm")
        os.execvpe(sys.executable, [sys.executable, "-m",
                                    "mri_superresolution_torch.cli.ui"], env)
    out, menu_s, code = b"", None, None
    try:
        deadline = time.time() + 60
        while time.time() < deadline and \
                b"Start Inference Server" not in out:
            if select.select([fd], [], [], 0.3)[0]:
                try:
                    out += os.read(fd, 65536)
                except OSError:
                    break
        menu_s = time.perf_counter() - t0
        os.write(fd, b"q")
        deadline = time.time() + 20
        while time.time() < deadline:
            done, status = os.waitpid(pid, os.WNOHANG)
            if done:
                pid, code = 0, os.waitstatus_to_exitcode(status)
                break
            time.sleep(0.1)
    finally:
        if pid:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        os.close(fd)
    return {"menu": all(t in out for t in (
        b"MRI Super-Resolution Tool", b"Extract Paired Slices",
        b"Train Super-Resolution Model", b"Start Inference Server")),
        "menu_s": menu_s, "exit_code": code}


def eval_path(dev, smi: str, roots: dict) -> dict:
    """The evaluation tooling through its entry points on the card, on
    the extraction phase's 50 held-out pairs (256^2 HR, 128^2 LR), its two
    test volumes and its trained full-width checkpoints:
    ``cli.evaluate --checkpoint`` over the 50 pairs under PyTorch's
    default TF32 flags (metrics.csv of 200 rows with the JAX columns,
    report.json naming the card and its power limit, exact launches, each
    method's median ms/image; bf16 and the baselines on 2 content pairs
    against the CPU port at the bf16 budget), again with ``--quant int8``
    and with ``--tta`` over EVAL_SUBSET content pairs; both ablation modes
    (best and final; two loss configurations trained for one epoch on the
    train split in child processes); ``cli.test_model`` on the test
    volumes; ``cli.test_comparison --seed 0 --tta`` against the CPU
    port's pick; the SSIM sweep (``cli.test_ssim_weights``, two weights,
    one epoch each) and ``cli.compare_ssim_detailed`` over its runs;
    ``cli.visualise_res`` over the eight volumes; the final checkpoint
    exported to a reference ``.pth`` that serves the same bits, and back;
    the TUI under a pty, and the infer command its menu builds run on the
    card. Every launch of the phase is counted, each run's exactly."""
    start = time.perf_counter()
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    EVAL_DIR.mkdir(parents=True)
    ck = EXTRACT_DIR / "ckpt"
    final = str(ck / "final_model_unet.ckpt")
    hr_dir, lr_dir = str(EXTRACT_DIR / "hr_test"), str(EXTRACT_DIR / "lr_test")
    pairs = quality.held_out_pairs(lr_dir, hr_dir)
    n = len(pairs)
    lrs = quality.read_pngs([a for a, _ in pairs])
    hrs = quality.read_pngs([b for _, b in pairs])
    fg = np.abs(lrs).reshape(n, -1) > FOREGROUND_INTENSITY
    content = np.flatnonzero(quality.content_pairs(hrs) & (
        fg.mean(axis=1) >= InferConfig().quant_min_foreground))
    subset = [os.path.basename(pairs[i][0]) for i in content[:EVAL_SUBSET]]
    hr8, lr8 = _copy_pairs(subset, EVAL_DIR / "subset")
    keys = kernels.launch_counts()
    totals = dict.fromkeys(keys, 0)
    res = {}

    # cli.evaluate --checkpoint over the 50 pairs, as users run it
    # (PyTorch's default flags: cuDNN's TF32 on; matmul TF32 off)
    engines = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        rc, secs, counts, routes = _counted_run(lambda: _eval_main(
            ["--hr_dir", hr_dir, "--lr_dir", lr_dir, "--checkpoint", final,
             "--output_dir", str(EVAL_DIR / "single")], engines), totals)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    header, rows = _csv_rows(EVAL_DIR / "single" / "metrics.csv")
    with open(EVAL_DIR / "single" / "report.json") as f:
        report = json.load(f)
    hw = report["hardware"]
    fwd = 1 + n + 5      # warm-up, the pairs, the 5 qualitative pairs
    ms = _median_ms(rows)
    ok = rc == 0 and header == EVAL_COLUMNS and len(rows) == 4 * n and \
        all(sorted(r["method"] for r in rows if r["image"] == img) ==
            sorted(EVAL_METHODS) for img in {r["image"] for r in rows}) and \
        hw["accelerator"] == torch.cuda.get_device_name(0) and \
        hw["nvidia_smi"] == smi and \
        hw["power_limit"] == smi.split(",")[-1].strip() and \
        report["implementation"]["base_filters"] == BASE_FILTERS
    _gate("eval_checkpoint", counts, _want(fwd, 0, n + 5, keys), routes, ok,
          rc=rc, pairs=n, rows=len(rows), columns=header, seconds=secs,
          hardware=hw, median_ms_per_image=ms, forwards=fwd,
          timing="host clock of each method per image, ending when its "
                 "output is on the host (evaluate.py's window); cuDNN "
                 "TF32 at PyTorch's default (on)")
    res["checkpoint"] = {"seconds": secs, "median_ms": ms}

    # bf16 and the baselines on 2 content pairs against the CPU port
    two = [pairs[i] for i in content[:2]]
    cpu_rows = eval_cli.run_benchmarks(two, load_engine(
        InferConfig(checkpoint_path=final), device="cpu"))
    card = {(r["image"], r["method"]): r for r in rows}
    deltas = {}
    for r in cpu_rows:
        c = card[(r["image"], r["method"])]
        d = deltas.setdefault(r["method"], {"d_psnr_db": 0.0, "d_ssim": 0.0,
                                            "d_mae": 0.0})
        for k, m in (("d_psnr_db", "psnr"), ("d_ssim", "ssim"),
                     ("d_mae", "mae")):
            d[k] = max(d[k], abs(float(c[m]) - r[m]))
    ok = len(cpu_rows) == 8 and all(d["d_psnr_db"] <= 0.1 and
                                    d["d_ssim"] <= 1e-3
                                    for d in deltas.values())
    log("eval_cpu_vs_gpu", pairs=[r["image"] for r in cpu_rows[::4]],
        deltas=deltas, budget="|dPSNR| <= 0.1 dB, |dSSIM| <= 1e-3",
        baselines="fp32: bilinear and bicubic by resampling matmuls, the "
                  "sharpen by nine fp32 taps (no convolution, so cuDNN's "
                  "TF32 cannot reach it)", ok=ok)
    if not ok:
        raise AssertionError(f"evaluate on the card against the CPU port: "
                             f"{deltas}")
    res["cpu_vs_gpu"] = deltas

    # --quant int8 and --tta over the content subset
    m = len(subset)
    fwd = 1 + m + 5
    engines = []
    rc, secs, counts, routes = _counted_run(lambda: _eval_main(
        ["--hr_dir", hr8, "--lr_dir", lr8, "--checkpoint", final,
         "--output_dir", str(EVAL_DIR / "int8"), "--quant", "int8"],
        engines), totals)
    served = dict(engines[0]._quant_batches)
    _, rows = _csv_rows(EVAL_DIR / "int8" / "metrics.csv")
    _gate("eval_int8", counts, _want(served["bf16"], served["int8"], m + 5,
                                     keys), routes,
          rc == 0 and len(rows) == 4 * m and served["int8"] > 0 and
          sum(served.values()) == fwd, rc=rc, pairs=m, served=served,
          seconds=secs, median_ms_per_image=_median_ms(rows))
    res["int8"] = {"seconds": secs, "median_ms": _median_ms(rows),
                   "served": served}
    rc, secs, counts, routes = _counted_run(lambda: _eval_main(
        ["--hr_dir", hr8, "--lr_dir", lr8, "--checkpoint", final,
         "--output_dir", str(EVAL_DIR / "tta"), "--tta"], []), totals)
    _, rows = _csv_rows(EVAL_DIR / "tta" / "metrics.csv")
    _gate("eval_tta", counts, _want(8 * fwd, 0, m + 5, keys), routes,
          rc == 0 and len(rows) == 4 * m, rc=rc, pairs=m, members=8,
          seconds=secs, median_ms_per_image=_median_ms(rows))
    res["tta"] = {"seconds": secs, "median_ms": _median_ms(rows)}

    # --ablation_checkpoints_dir over best and final
    abl = EVAL_DIR / "ckpts"
    abl.mkdir()
    for name in ("best_model_unet", "final_model_unet"):
        for suffix in (".ckpt", ".json"):
            shutil.copy(ck / f"{name}{suffix}", abl / f"{name}{suffix}")
    rc, secs, counts, routes = _counted_run(lambda: _eval_main(
        ["--hr_dir", hr8, "--lr_dir", lr8, "--ablation_checkpoints_dir",
         str(abl), "--output_dir", str(EVAL_DIR / "ablation")], []), totals)
    _, rows = _csv_rows(EVAL_DIR / "ablation" / "metrics_ablation.csv")
    with open(EVAL_DIR / "ablation" / "ablation_summary.json") as f:
        summary = json.load(f)
    _gate("eval_ablation_dir", counts, _want(2 * fwd, 0, 2 * (m + 5), keys),
          routes, rc == 0 and [r["checkpoint"] for r in rows] ==
          ["best_model_unet"] * (4 * m) + ["final_model_unet"] * (4 * m) and
          sorted(summary) == ["best_model_unet.ckpt", "final_model_unet.ckpt"]
          and (EVAL_DIR / "ablation" / "report_base.json").exists(),
          rc=rc, rows=len(rows), summary=summary, seconds=secs)

    # --ablation_train_configs: two loss configurations, each trained for
    # one epoch on the train split by the train CLI in a child process
    configs = EVAL_DIR / "configs.json"
    configs.write_text(json.dumps([{"ssim_weight": float(w)}
                                   for w in EVAL_WEIGHTS]))
    out_log = EVAL_DIR / "ablation_train.log"
    with _cwd(EVAL_DIR), _fds_to(out_log):
        rc, secs, counts, routes = _counted_run(lambda: _eval_main(
            ["--hr_dir", hr8, "--lr_dir", lr8, "--ablation_train_configs",
             str(configs), "--train_epochs", "1", "--train_full_res_dir",
             str(EXTRACT_DIR / "hr_train"), "--train_low_res_dir",
             str(EXTRACT_DIR / "lr_train"), "--output_dir",
             str(EVAL_DIR / "ablation_train")], []), totals)
    names = [f"ssim_{float(w)}_perc_0.0" for w in EVAL_WEIGHTS]
    _, rows = _csv_rows(EVAL_DIR / "ablation_train" / "metrics_ablation.csv")
    with open(EVAL_DIR / "ablation_train" / "ablation_summary.json") as f:
        summary = json.load(f)
    lines = _json_lines(out_log)
    on_card = sum(ln.get("message", "").startswith("Training on cuda")
                  for ln in lines)
    trained = [(EVAL_DIR / "ablation_checkpoints" / nm /
                "final_model_unet.ckpt").exists() for nm in names]
    _gate("eval_ablation_train", counts, _want(2 * fwd, 0, 2 * (m + 5),
                                               keys), routes,
          rc == 0 and all(trained) and on_card == 2 and
          sorted(summary) == sorted(names) and
          [r["checkpoint"] for r in rows] == [names[0]] * (4 * m) +
          [names[1]] * (4 * m), rc=rc, configs=names, trained=trained,
          children_on_card=on_card, seconds=secs,
          epochs=[ln for ln in lines if ln.get("type") == "epoch_summary"],
          note="launches counted in this process: the evaluations; the "
               "children's training is theirs")
    res["ablation_train_s"] = secs

    # cli.test_model on the two test volumes
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    pkg_logger = logging.getLogger("mri_superresolution_torch")
    pkg_logger.addHandler(handler)
    try:
        with _cwd(EVAL_DIR):
            rc, secs, counts, routes = _counted_run(lambda: test_model_cli.main(
                ["--test_dataset", str(roots["test"]), "--output_dir",
                 str(EVAL_DIR / "test_model"), "--checkpoint_dir", str(ck),
                 "--n_slices", str(EVAL_SUBSET)]), totals)
    finally:
        pkg_logger.removeHandler(handler)
    tm = EVAL_DIR / "test_model"
    # the larger side of the volumes' slices, up to a multiple of 8
    canvas = -(-max(EXTRACT_SHAPE[:2]) // 8) * 8
    sizes = {d: sorted({_png_hw(p) for p in (tm / d).iterdir()})
             for d in ("hr_slices", "lr_slices", "enhanced")}
    averages = [r.getMessage() for r in records
                if r.getMessage().startswith(("Average SSIM", "Average RMSE",
                                              "Average MAE"))]
    grid = (tm / "results_summary.png").exists()
    _gate("eval_test_model", counts, _want(EVAL_SUBSET, 0, EVAL_SUBSET, keys),
          routes, rc == 0 and len(list((tm / "enhanced").iterdir())) ==
          EVAL_SUBSET and sizes == {"hr_slices": [(canvas, canvas)],
                                    "lr_slices": [(canvas // 2,
                                                   canvas // 2)],
                                    "enhanced": [(canvas, canvas)]} and
          len(averages) == 3, rc=rc, png_sizes=sizes, averages=averages,
          summary_grid=grid, seconds=secs)

    # cli.test_comparison --seed 0 --tta, and the CPU port's pick
    argv = ["--test_dataset", str(roots["test"]), "--checkpoint_dir",
            str(ck), "--seed", "0", "--tta"]
    with _cwd(EVAL_DIR), contextlib.redirect_stdout(io.StringIO()):
        rc, secs, counts, routes = _counted_run(lambda: comparison_cli.main(
            argv + ["--output_dir", str(EVAL_DIR / "cmp")]), totals)
        rc_cpu = comparison_cli.main(argv + ["--output_dir",
                                             str(EVAL_DIR / "cmp_cpu"),
                                             "--cpu"])
    table = (EVAL_DIR / "cmp" / "metrics.txt").read_text().splitlines()
    table_cpu = (EVAL_DIR / "cmp_cpu" / "metrics.txt").read_text(
    ).splitlines()
    _gate("eval_test_comparison", counts, _want(8, 0, 1, keys), routes,
          rc == 0 and rc_cpu == 0 and table[2] == table_cpu[2] and
          len(table) == len(table_cpu) == 10 and
          [ln.split("|")[1].strip() for ln in table[6:]] ==
          ["AI Model", "Bilinear", "Sharp Bilinear", "Bicubic"],
          rc=rc, rc_cpu=rc_cpu, pair=table[2], cpu_pair=table_cpu[2],
          rows=table[6:], cpu_rows=table_cpu[6:], seconds=secs,
          note="the LR noise of the card's and the CPU's generators "
               "differ, so the rows' values do")

    # the SSIM sweep (two weights, one epoch each, in child processes),
    # then the detailed comparison over its runs
    sweep_log = EVAL_DIR / "sweep.log"
    with _fds_to(sweep_log):
        t0 = time.perf_counter()
        sweep = sweep_cli.main(
            ["--full_res_dir", str(EXTRACT_DIR / "hr_train"),
             "--low_res_dir", str(EXTRACT_DIR / "lr_train"),
             "--ssim_weights", *EVAL_WEIGHTS, "--epochs", "1",
             "--output_dir", str(EVAL_DIR / "sweep")])
        sweep_s = time.perf_counter() - t0
    lines = _json_lines(sweep_log)
    runs = {w: (Path(sweep) / f"ssim_weight_{float(w)}" /
                "final_model_unet.ckpt").exists() for w in EVAL_WEIGHTS}
    import importlib.util
    plotting = importlib.util.find_spec("matplotlib") is not None
    with contextlib.redirect_stdout(io.StringIO()):
        rc, secs, counts, routes = _counted_run(lambda: detailed_cli.main(
            ["--weight_dirs", sweep, "--test_image_dir", lr_dir,
             "--output_dir", str(EVAL_DIR / "detailed")]), totals)
    images = sorted(p.name for p in (EVAL_DIR / "detailed").iterdir())
    files = {i: sorted(p.name for p in (EVAL_DIR / "detailed" / i).iterdir())
             for i in images}
    want_files = sorted(["original.png"] + [f"weight_{float(w)}.png"
                                            for w in EVAL_WEIGHTS] +
                        ["comparison.png"] * plotting)
    _gate("eval_sweep", counts, _want(2 * 5, 0, 0, keys), routes,
          rc == 0 and all(runs.values()) and len(images) == 5 and
          all(f == want_files for f in files.values()) and
          sum(ln.get("message", "").startswith("Training on cuda")
              for ln in lines) == 2, sweep_dir=sweep, runs=runs,
          sweep_s=sweep_s, collage=(Path(sweep) /
                                    "ssim_weight_comparison.png").exists(),
          matplotlib=plotting, images=images, files=files,
          detailed_seconds=secs)

    # cli.visualise_res over the eight volumes
    vols = EVAL_DIR / "volumes"
    vols.mkdir()
    for split, root in roots.items():
        (vols / split).symlink_to(root / "set1")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = res_cli.main(["--root_dir", str(vols), "--output_png_dir",
                           str(EVAL_DIR / "mid"), "--output_viz_file",
                           str(EVAL_DIR / "resolutions.png")])
    mids = sorted({_png_hw(p) for p in (EVAL_DIR / "mid").iterdir()})
    row = (EXTRACT_SHAPE[1], EXTRACT_SHAPE[0], sum(EXTRACT_VOLUMES.values()))
    from mri_superresolution_torch.evalsuite.resolution import format_table
    ok = rc == 0 and format_table([row]) in printed.getvalue() and \
        mids == [(EXTRACT_SHAPE[0], EXTRACT_SHAPE[1])] and \
        len(list((EVAL_DIR / "mid").iterdir())) == len(
            find_nifti_files(str(vols)))
    log("eval_visualise_res", rc=rc, table=format_table([row]),
        mid_png_sizes=mids, ok=ok)
    if not ok:
        raise AssertionError(f"visualise_res: rc {rc}, printed "
                             f"{printed.getvalue()[-500:]}, sizes {mids}")

    # the final checkpoint to a reference .pth, served; and back
    pth = str(EVAL_DIR / "final_model_unet.pth")
    with contextlib.redirect_stdout(io.StringIO()):
        export_torch_checkpoint.main(["--ckpt", final, "--out", pth])
        convert_torch_checkpoint.main(["--pth", pth, "--out",
                                       str(EVAL_DIR / "back.ckpt")])
    batch = lrs[content[:EVAL_SUBSET]]
    outs, _, counts, routes = _counted_run(lambda: [
        load_engine(InferConfig(checkpoint_path=p), device=dev)
        .upscale_batch(batch) for p in (final, pth)], totals)
    back, _ = ckpt.load_params_any(str(EVAL_DIR / "back.ckpt"))
    orig, _ = ckpt.load_params_any(final)
    _gate("eval_export", counts, _want(2, 0, 0, keys), routes,
          np.array_equal(outs[0], outs[1]) and
          all(torch.equal(back[k], v) for k, v in orig.items()),
          same_bits=bool(np.array_equal(outs[0], outs[1])),
          round_trip_equal=all(torch.equal(back[k], v)
                               for k, v in orig.items()),
          pth_mib=os.path.getsize(pth) / 2**20)

    # the TUI, and the infer command its menu builds, on the card
    t = _tui_renders()
    p = dict(tui.DEFAULT_PARAMS, input_image=pairs[content[0]][0],
             target_image=pairs[content[0]][1],
             output_image=str(EVAL_DIR / "tui_sr.png"),
             checkpoint_dir=str(ck), checkpoint_file=final)
    cmd = tui.build_command("infer", p)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=child_env(), capture_output=True, text=True,
                       timeout=300, cwd=EVAL_DIR)
    t["infer_s"] = time.perf_counter() - t0
    out_png = _png_hw(p["output_image"]) \
        if os.path.exists(p["output_image"]) else None
    ok = t["menu"] and t["exit_code"] == 0 and r.returncode == 0 and \
        out_png == (EXTRACT_TARGET, EXTRACT_TARGET) and "--cpu" not in cmd
    log("eval_tui", **t, command=cmd[1:], infer_rc=r.returncode,
        output=out_png, infer_log=r.stderr.splitlines()[-4:], ok=ok)
    if not ok:
        raise AssertionError(f"the TUI: {t}, infer rc {r.returncode}, "
                             f"output {out_png}; {r.stderr[-2000:]}")
    log("eval_path", launches=totals, seconds=time.perf_counter() - start)
    return {"launches": totals, **res,
            "seconds": time.perf_counter() - start}


def perceptual_path(dev) -> dict:
    """The unet's training with the perceptual term (``perceptual_weight``
    0.1, VGG19 to relu5_4 on seeded random weights, as the trainer falls
    back without ``--vgg_weights``): the train CLI for one epoch; one step
    counted alone; step ms at batch 8 of 128^2 -> 256^2 with cuDNN's TF32
    on and off, beside the same step without the term (VGG's share); one
    step's loss and gradients on the card against the CPU port, each of
    its two parts at the training gate (``card_vs_cpu_step``), TF32
    off."""
    run = _train_cli(ZOO_DIR / "ckpt_perceptual",
                     ["--perceptual_weight", str(PERC_WEIGHT)])
    counts, summaries = run["launches"], run["by_type"].get(
        "epoch_summary", [])
    warned = any("RANDOM VGG" in ln.get("message", "")
                 for lines in run["by_type"].values() for ln in lines)
    steps = run["steps"]
    log("perceptual_train", launches=counts, expected=run["expected"],
        backward_onepass=run["backward_onepass"],
        epoch_summaries=summaries, random_vgg_warning=warned,
        checkpoint=run["final"])
    if counts != run["expected"] or run["backward_onepass"] != 20 * steps \
            or len(summaries) != 1 or not warned or \
            not np.isfinite(summaries[0]["train_loss"]):
        raise AssertionError(f"perceptual training: launches {counts}, "
                             f"expected {run['expected']}, B1 backward "
                             f"one-pass {run['backward_onepass']} of "
                             f"{20 * steps}; {summaries}; warning {warned}")

    cfg = ModelConfig(base_filters=BASE_FILTERS)
    lcfg = LossConfig(perceptual_weight=PERC_WEIGHT)
    vgg_params = vgg_mod.random_params(torch.Generator().manual_seed(0),
                                       lcfg.vgg_layer_idx)
    vgg = vgg_mod.VGG19Features.from_params(vgg_params,
                                            lcfg.vgg_layer_idx).to(dev)
    batch = _train_batch(dev, TRAIN_BATCH, TRAIN_LR)
    times = {}
    for name, loss_fn in (("perceptual", CombinedLoss(lcfg, vgg)),
                          ("l1_ssim", CombinedLoss(LossConfig()))):
        model = build_model(cfg, dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(
                                TRAIN_SEED)).to(dev)
        state = trainer.TrainState(model, trainer.make_optimizer(
            model.parameters(), 1e-4, 1e-5))
        step = trainer.build_train_step(loss_fn)
        if name == "perceptual":
            per_step = _step_counts(lambda: step(state, batch, 1e-4))
        torch.cuda.reset_peak_memory_stats()
        for tf32 in (False, True, True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            times.setdefault(f"{name}_tf32_{'on' if tf32 else 'off'}",
                             []).append(cuda_ms(lambda: step(state, batch,
                                                             1e-4),
                                                iters=STEP_ITERS, warmup=2))
        torch.backends.cudnn.allow_tf32 = False
        times[f"{name}_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    ms = {k: sum(v) / len(v) for k, v in times.items()
          if not k.endswith("gb")}
    share = {f"tf32_{t}": 1.0 - ms[f"l1_ssim_tf32_{t}"] /
             ms[f"perceptual_tf32_{t}"] for t in ("on", "off")}
    log("perceptual_step", batch=TRAIN_BATCH, lr=[TRAIN_LR, TRAIN_LR],
        launches=per_step, times=times, step_ms=ms, vgg_share=share,
        timing="CUDA events around 10 steps after 2 warm-up steps, in "
               "turns TF32 off, on, on, off")
    want = {"group_norm_leaky": 20, "group_norm_leaky_backward": 20,
            "group_norm_leaky_backward.onepass": 20, "conv3x3": 2,
            "ssim_per_sample": 1}
    if per_step != want:
        raise AssertionError(f"perceptual step launches {per_step}")
    # the gate in both of cuDNN's modes: TF32 off, and on (PyTorch's
    # default, the mode users train in)
    gate = card_vs_cpu_step(dev, cfg, lcfg, vgg_params, tf32_too=True)
    return {"launches": counts, "step_ms": ms, "vgg_share": share,
            "gate": gate}


# ------------------------------------------------ data parallel + phase

DP_DIR = SCALES_PATH.parent / "dp"
DP_RANK_BATCH = TRAIN_BATCH // 2     # a rank's rows of the training batch
DP_CHUNK = BATCH // 2                # a device's chunk of the serving batch
DP_TIME_STEPS = 5
DP_GLOO_NOTE = "gloo, one card, not representative"


def _b1_fp32_check(shape, dev, gen, served_by: str) -> float:
    """B1 in fp32 at ``shape`` through its wrapper against the plain
    version (rtol and atol 1e-5, tests/test_torch_cuda.py's fp32 gate),
    and run to run."""
    x = torch.randn(shape, generator=gen, device=dev).contiguous(
        memory_format=torch.channels_last)
    g = torch.randn(shape[1], generator=gen, device=dev)
    b = torch.randn(shape[1], generator=gen, device=dev)
    got = group_norm_leaky(x, g, b)
    ok, err = within(got, group_norm_leaky_plain(x, g, b), 1e-5, 1e-5)
    same = torch.equal(got, group_norm_leaky(x, g, b))
    log("kernel_check", kernel="B1", route="wrapper", shape=list(shape),
        served_by=served_by, dtype="fp32", max_abs_err=err, rtol=1e-5,
        atol=1e-5, run_to_run_equal=same, ok=ok)
    if not (ok and same):
        raise AssertionError(f"B1 (fp32) disagrees with its plain version "
                             f"at {shape} ({err}) or from run to run")
    return err


def check_dp_phase_kernels(dev, gen) -> None:
    """Every kernel against its plain version at the shapes the
    data-parallel and phase_final phase adds: B1 (both routes) and B3 at a
    rank's batch and a device's chunk, B1's backward at a rank's batch
    (B2's (4, 256^2) is in ``B2_CHECK_SHAPES``), B4 and its fused route at
    a chunk's 20 int8 sites, and B1 in fp32 at the five shapes of the
    phase_final forward (its C = 64 phase norms in bf16 are C64_FWD's)."""
    f = BASE_FILTERS
    for n, lr, by in ((DP_RANK_BATCH, TRAIN_LR, "dp rank step"),
                      (DP_CHUNK, LR, "dp engine chunk")):
        for shape, _ in gn_sites(n, lr, f):
            b1_check(*b1_inputs(shape, dev, gen), by)
        for ci, co in ((f, f // 2), (f // 2, f // 2)):
            b3_check(*b3_inputs(n, ci, co, 2 * lr, dev, gen), by)
    check_b1_backward_sites(dev, gen, DP_RANK_BATCH, TRAIN_LR, "dp rank step")
    for site, shape, slope in b4_sites(DP_CHUNK, LR, f):
        b4_site_check(site, shape, slope, dev, gen)
        if slope != 1.0:
            fused_site_check(site, shape, slope, dev, gen)
    for shape in [s for s, _ in gn_sites(BATCH, LR, f)[:4]] + \
            [(BATCH, 2 * f, LR, LR)]:
        _b1_fp32_check(shape, dev, gen, "phase_final fp32 forward")


def _dp_world1_nccl(trained: dict) -> dict:
    """The train CLI as the training phase ran it, as host 0 of a job of
    one (NCCL on the card) with ZeRO-1: the same checkpoint bytes."""
    ck = DP_DIR / "ckpt_world1"
    port = multihost_mod.free_port()
    run = _train_cli(ck, ["--multihost", "--coordinator",
                          f"127.0.0.1:{port}", "--num_processes", "1",
                          "--process_id", "0", "--opt_shard"],
                     epochs=TRAIN_EPOCHS)
    digests = _ckpt_digests(ck)
    lines = [ln.get("message", "") for v in run["by_type"].values()
             for ln in v]
    zero1 = any("ZeRO-1 optimizer-state sharding" in m for m in lines)
    group = [re.search(r"\((nccl|gloo)\)", m) for m in lines
             if m.startswith("Multi-host training:")]
    backend = group[0].group(1) if group and group[0] else None
    params = run["by_type"].get("params", [{}])[0]
    log("dp_world1_nccl", backend=backend, world=1, opt_shard=True,
        seconds=run["seconds"], launches=run["launches"],
        expected=run["expected"], checkpoints=digests,
        plain_run=trained["digests"], zero1_logged=zero1,
        num_devices=params.get("num_devices"))
    if digests != trained["digests"] or run["launches"] != run["expected"] \
            or not zero1 or params.get("num_devices") != 1 or \
            backend != "nccl":
        raise AssertionError(f"NCCL world of one ({backend}): checkpoints "
                             f"{digests} "
                             f"against the plain run's "
                             f"{trained['digests']}, launches "
                             f"{run['launches']} (expected "
                             f"{run['expected']}), ZeRO-1 line {zero1}")
    return run["launches"]


def _drawn_zeros(sd: dict, seed: int) -> dict:
    """``sd`` with its all-zero tensors (biases, alpha) drawn from N(0,
    0.05): from zero a tensor's relative L2 after Adam's first step is its
    update's alone, which moves by a large share wherever a gradient is
    near eps."""
    g = torch.Generator().manual_seed(seed)
    return {k: (v if bool(v.any()) else
                0.05 * torch.randn(v.shape, generator=g))
            for k, v in sd.items()}


def _rel_max(a: dict, b: dict) -> tuple:
    return max((float((a[k].double() - b[k].double()).norm()
                      / b[k].double().norm().clamp_min(1e-30)), k)
               for k in b)


def _dp_two_ranks(dev) -> dict:
    """Two rank processes on cuda:0 over gloo through
    ``tools/dp_step.run_rank`` at the training batch: bf16 against the
    same ranks as threads of this process (bits), ZeRO-1 against the
    replicated update (bits), the ranks' copies (bits); fp32 (TF32 off)
    within 1e-5 relative L2 a tensor of one process that runs the same
    rows at the ranks' batch of 4 (``grad_accum`` 2), params and first
    moments; the gap to one process on the global batch of 8 is logged
    beside that process's own gap between its batches of 4 and of 8,
    with the parameter elements whose first Adam step, lr times the
    gradient's sign where it is not near 0, went the other way (moved
    by more than lr / 2); one rank-step's launches; step and all-reduce
    ms a rank."""
    sd = _drawn_zeros(build_model(
        ModelConfig(base_filters=BASE_FILTERS),
        generator=torch.Generator().manual_seed(TRAIN_SEED)).state_dict(), 1)
    batch = {k: v.cpu().numpy() for k, v in
             _train_batch("cpu", TRAIN_BATCH, TRAIN_LR).items()}

    def case(name, **kw):
        return {"name": name, "model": {"base_filters": BASE_FILTERS},
                "state_dict": sd, "batch": batch, "lr": 1e-4,
                "weight_decay": 1e-5, "dtype": "bfloat16", **kw}

    cases = [case("bf16", time_steps=DP_TIME_STEPS),
             case("bf16_zero1", opt_shard=True),
             case("fp32", dtype="float32")]
    out = DP_DIR / "ranks"
    out.mkdir(parents=True)
    torch.save({"cases": cases, "allow_tf32": False}, out / "spec.pt")
    t0 = time.perf_counter()
    rc = multihost_mod.launch(
        "mri_superresolution_torch.tools.dp_step:run_rank",
        [str(out / "spec.pt"), str(out)], [dev, dev],
        f"127.0.0.1:{multihost_mod.free_port()}", 2, backend="gloo")
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"the two gloo ranks on one card exited {rc}")
    res = {c["name"]: [torch.load(out / f"{c['name']}.rank{r}.pt",
                                  weights_only=False) for r in (0, 1)]
           for c in cases}
    threads = dp_step.run_threads(cases[0], 2, dev)
    alone = dp_step.run_case(cases[2], dev)
    alone4 = dp_step.run_case(dict(cases[2], grad_accum=2), dev)

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in b)

    r0 = res["bf16"][0]
    checks = {
        "ranks_equal": all(same(res[n][0]["params"], res[n][1]["params"])
                           for n in res),
        "threads_equal": all(same(threads[r]["params"],
                                  res["bf16"][r]["params"])
                             and same(threads[r]["adam"]["nu"],
                                      res["bf16"][r]["adam"]["nu"])
                             for r in (0, 1)),
        "zero1_equal": same(res["bf16_zero1"][0]["params"], r0["params"])
        and same(res["bf16_zero1"][0]["adam"]["mu"], r0["adam"]["mu"])
        and same(res["bf16_zero1"][0]["adam"]["nu"], r0["adam"]["nu"])}
    fp32 = res["fp32"][0]
    gaps = {"vs_batch4_params": _rel_max(fp32["params"], alone4["params"]),
            "vs_batch4_mu": _rel_max(fp32["adam"]["mu"], alone4["adam"]["mu"]),
            "vs_batch8_params": _rel_max(fp32["params"], alone["params"]),
            "vs_batch8_mu": _rel_max(fp32["adam"]["mu"], alone["adam"]["mu"]),
            "control_batch4_vs_8_mu": _rel_max(alone4["adam"]["mu"],
                                               alone["adam"]["mu"]),
            "control_batch4_vs_8_params": _rel_max(alone4["params"],
                                                   alone["params"])}
    fp32_ok = (gaps["vs_batch4_params"][0] <= 1e-5
               and gaps["vs_batch4_mu"][0] <= 1e-5)
    lr = cases[2]["lr"]
    flips = {k: int(((fp32["params"][k].double()
                      - alone["params"][k].double()).abs() > lr / 2).sum())
             for k in alone["params"]}
    flips = {k: n for k, n in flips.items() if n}
    want = {"group_norm_leaky": 20, "group_norm_leaky_backward": 20,
            "conv3x3": 2, "ssim_per_sample": 1}
    launches = [res[n][r]["launches"] for n in ("bf16", "fp32")
                for r in (0, 1)]
    share = res["bf16_zero1"][0]["moment_bytes"] / r0["moment_bytes"]
    log("dp_two_ranks_one_card", backend=r0["backend"], ranks=2,
        device=str(dev), batch=TRAIN_BATCH, rank_batch=DP_RANK_BATCH,
        lr=[TRAIN_LR, TRAIN_LR], **checks,
        fp32_rel_l2={k: v[0] for k, v in gaps.items()},
        fp32_rel_l2_tensor={k: v[1] for k, v in gaps.items()},
        fp32_ok=fp32_ok, fp32_vs_batch8_sign_flips=flips,
        zero1_moment_share=share, rank_step_launches=launches,
        step_ms=[res["bf16"][r]["step_ms"] for r in (0, 1)],
        allreduce_ms=[res["bf16"][r]["allreduce_ms"] for r in (0, 1)],
        allreduce_bytes=r0["allreduce_bytes"], seconds=seconds,
        timing=f"{DP_GLOO_NOTE}: host clock around {DP_TIME_STEPS} bf16 "
               f"steps after one, and around {DP_TIME_STEPS} all-reduces "
               f"of the fp32 gradient bucket alone, each synchronized")
    if not all(checks.values()) or not fp32_ok or \
            any(c != want for c in launches) or not 0.5 <= share <= 0.52:
        raise AssertionError(f"two ranks on one card: {checks}, fp32 "
                             f"{gaps}, launches {launches}, ZeRO-1 "
                             f"moment share {share}")
    total = {}
    for n in ("bf16", "fp32", "bf16_zero1"):
        for r in (0, 1):
            _add(total, res[n][r]["launches"])
    return {"launches": total,
            "step_ms": [res["bf16"][r]["step_ms"] for r in (0, 1)],
            "allreduce_ms": [res["bf16"][r]["allreduce_ms"] for r in (0, 1)]}


def _dp_engine(dev, cfg, params, lr) -> dict:
    """``InferenceEngine(devices=[cuda:0, cuda:0])`` on the serving batch
    in bf16, frozen int8 and TTA: each half bit-equal to the one-device
    engine's batch of 8, the launches two chunks make."""
    path = DP_DIR / "scales.json"
    one = InferenceEngine(cfg, params, device=dev)
    x = torch.from_numpy(lr[..., None]).to(dev)
    quant_forward.save_scales(str(path), quant_forward.calibrate(
        one._params, [x], "unet", torch.bfloat16), "unet")
    chunk = {"bf16": {"group_norm_leaky": 20, "conv3x3": 2},
             "int8": {"group_norm_leaky": 13, "gn_quantize": 7,
                      "leaky_quantize": 13},
             "tta": {"group_norm_leaky": 160, "conv3x3": 16}}
    modes = {"bf16": {}, "int8": {"quant": "int8",
                                  "quant_calib_path": str(path)},
             "tta": {"tta": True}}
    total, out = {}, {}
    for mode, kw in modes.items():
        two = InferenceEngine(cfg, params, devices=[dev, dev], **kw)
        ref = InferenceEngine(cfg, params, device=dev, **kw)
        two.upscale_batch(lr[:2])                         # warm
        before = dict(two._quant_batches)
        kernels.reset_launch_counts()
        got = two.upscale_batch(lr)
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        routed = {k: v - before[k] for k, v in two._quant_batches.items()}
        _add(total, counts)
        halves = [ref.upscale_batch(lr[:DP_CHUNK]),
                  ref.upscale_batch(lr[DP_CHUNK:])]
        equal = [bool(np.array_equal(got[i * DP_CHUNK:(i + 1) * DP_CHUNK],
                                     h)) for i, h in enumerate(halves)]
        want = {k: 2 * v for k, v in chunk[mode].items()}
        ms_two = cuda_ms(lambda: two.upscale_batch(lr), iters=5, warmup=1)
        ms_one = cuda_ms(lambda: ref.upscale_batch(lr), iters=5, warmup=1)
        out[mode] = {"two_devices_ms": ms_two, "one_device_ms": ms_one}
        log("dp_engine", mode=mode, devices=[str(dev)] * 2,
            slices=len(lr), chunk=DP_CHUNK, hw=[LR, LR],
            halves_bit_equal=equal, launches=counts, expected=want,
            quant_batches=routed if mode == "int8" else None,
            two_devices_ms=ms_two, one_device_ms=ms_one,
            timing="CUDA events around 5 upscale_batch calls after 1, "
                   "upload and fetch included; one card named twice, so "
                   "the two chunks share its SMs")
        if not all(equal) or counts != want or (
                mode == "int8" and routed != {"int8": 1, "bf16": 0}):
            raise AssertionError(f"two-device engine ({mode}): halves "
                                 f"equal {equal}, launches {counts} "
                                 f"(expected {want})")
    return {"launches": total, "ms": out}


def _phase_final(dev, params, lr, hr) -> dict:
    """The full-width unet with ``phase_final`` on the serving batch, fp32
    and bf16, against the dense forward on the card (fp32: rtol 1e-4,
    atol 1e-5; bf16: the bf16 budget against the ground truth) and the
    CPU port's phase_final (two slices, bf16 budget); B1 19 launches a
    forward, B3 none; forward ms beside the dense forward's."""
    from mri_superresolution_torch.models.unet import UNetSuperRes
    x = torch.from_numpy(lr[..., None]).to(dev)
    gt = hr
    res, launches = {}, {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        models = {}
        for pf in (True, False):
            m = UNetSuperRes(base_filters=BASE_FILTERS, dtype=dt,
                             phase_final=pf)
            m.load_state_dict(params)
            models[pf] = m.to(dev).eval()
        with torch.inference_mode():
            kernels.reset_launch_counts()
            got = models[True](x)
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            _add(launches, counts)
            dense = models[False](x)
            ms = cuda_ms(lambda: models[True](x), iters=10, warmup=2)
            dense_ms = cuda_ms(lambda: models[False](x), iters=10, warmup=2)
        g, d = got[..., 0].float().cpu().numpy(), dense[..., 0].float().cpu(
            ).numpy()
        if name == "fp32":
            ok, err = within(got, dense, 1e-4, 1e-5)
            gate = {"max_abs_err": err, "rtol": 1e-4, "atol": 1e-5}
        else:
            qa, qb = _quality(g, gt), _quality(d, gt)
            ok = _budget_quiet(qa, qb)["ok"]
            cpu = UNetSuperRes(base_filters=BASE_FILTERS, dtype=dt,
                               phase_final=True)
            cpu.load_state_dict(params)
            with torch.no_grad():
                c = cpu(torch.from_numpy(lr[:2, ..., None]))[..., 0].numpy()
            qc, qg = _quality(c, gt[:2]), _quality(g[:2], gt[:2])
            cpu_gate = _budget_quiet(qg, qc)
            ok = ok and cpu_gate["ok"]
            gate = {"card_phase": qa, "card_dense": qb,
                    "card_vs_cpu_port": cpu_gate}
        log("phase_final", dtype=name, batch=len(lr), lr=[LR, LR],
            launches=counts, forward_ms=ms, dense_forward_ms=dense_ms,
            ok=ok, **gate,
            timing="CUDA events around 10 forwards after 2, input on "
                   "the card")
        if not ok or counts != {"group_norm_leaky": 19}:
            raise AssertionError(f"phase_final ({name}): {gate}, launches "
                                 f"{counts}")
        res[name] = {"forward_ms": ms, "dense_forward_ms": dense_ms}
    return {"launches": launches, "ms": res}


def dp_phase_path(dev, cfg, params, lr, hr, trained) -> dict:
    """Data parallelism on one card (NCCL at a world of one, two gloo
    ranks, a two-device engine) and the phase_final forward; see the
    module's phase 14."""
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    check_dp_phase_kernels(dev, torch.Generator(device=dev).manual_seed(7))
    t0 = time.perf_counter()
    launches = {}
    _add(launches, _dp_world1_nccl(trained))
    ranks = _dp_two_ranks(dev)
    _add(launches, ranks["launches"])
    engine = _dp_engine(dev, cfg, params, lr)
    _add(launches, engine["launches"])
    phase = _phase_final(dev, params, lr, hr)
    log("dp_phase_path", seconds=time.perf_counter() - t0,
        dp_launches=launches, phase_launches=phase["launches"])
    return {"launches": launches, "phase_launches": phase["launches"],
            "ranks": ranks, "engine": engine["ms"], "phase": phase["ms"]}


# the row-sharded (spatial) phase: the full-width unet at 8 x 512^2 over 2
# and 4 shards of one card; int8, TTA and the CLIs at 4 x 256^2 over 2
SP_DIR = SCALES_PATH.parent / "spatial"
SP_BATCH, SP_LR, SP_SHARDS = 8, 512, (2, 4)
SP_SMALL, SP_SMALL_LR, SP_SMALL_SHARDS = 4, 256, 2
SP_FAMILIES = ("unet", "unet_tpu", "edsr", "simple")
SP_VOL = (128, 128, 8)

SPATIAL_CLIENT = r"""
import json, sys
import numpy as np
import torch
from mri_superresolution_torch import kernels
from mri_superresolution_torch.infer.export import load_artifact
from mri_superresolution_torch.utils.phantom import phantom_batch
args = json.loads(sys.argv[1])
lr = phantom_batch(np.random.default_rng(0), args["batch"], args["size"])
art = load_artifact(args["path"], devices=[torch.device("cuda", 0)]
                    * args["devices"])
kernels.reset_launch_counts()
np.save(args["out"], art.upscale_batch(lr))
torch.cuda.synchronize()
print(json.dumps({"spatial": art.spatial, "launches": {
    k: v for k, v in kernels.launch_counts().items() if v},
    "model_modules": sorted(m for m in sys.modules if m.startswith((
        "mri_superresolution_torch.models", "mri_superresolution_torch.train",
        "mri_superresolution_torch.infer.engine")))}))
"""


def _sp_counts() -> dict:
    torch.cuda.synchronize()
    return {k: v for k, v in kernels.launch_counts().items() if v}


def _psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 10.0 * math.log10(1.0 / mse) if mse > 0 else float("inf")


def _int8_quality(sp, dense, truth) -> dict:
    """The JAX package's contract between two int8 paths of a GroupNorm
    family (``tests/test_spatial.py``): as close to the fp32 truth as the
    other, within 1.1x in mean and 1.2x at the 0.999 quantile."""
    e_sp, e_d = np.abs(sp - truth), np.abs(dense - truth)
    q_sp, q_d = float(np.quantile(e_sp, 0.999)), float(np.quantile(e_d,
                                                                    0.999))
    return {"mean_err": float(e_sp.mean()), "dense_mean_err":
            float(e_d.mean()), "q999_err": q_sp, "dense_q999_err": q_d,
            "ok": bool(e_sp.mean() <= 1.1 * e_d.mean() + 1e-5
                       and q_sp <= 1.2 * q_d + 1e-3)}


def spatial_b3_check(dev, gen, batch: int, hr: int, shards,
                     served_by: str) -> None:
    """B3 on the 1-row haloed blocks of the unet's two narrow sites of a
    ``batch`` x ``hr``^2 image over each count of ``shards``: bf16 and
    fp32 against the plain version (bf16 also run to run); the cropped
    rows, gathered, bit-equal to the dense kernel's rows."""
    from mri_superresolution_torch.parallel import spatial
    f = BASE_FILTERS
    for n in shards:
        group = spatial.SpaceGroup([dev] * n)
        where = f"{served_by} of {n}"
        for ci, co in ((f, f // 2), (f // 2, f // 2)):
            for dt in (torch.bfloat16, torch.float32):
                x, w = b3_inputs(batch, ci, co, hr, dev, gen)
                x, w = x.to(dt).contiguous(memory_format=torch.channels_last
                                           ), w.to(dt)
                blocks = [x[:, :, i * hr // n:(i + 1) * hr // n]
                          for i in range(n)]
                ext = group.halo(blocks, 1, 1)[1]
                if dt == torch.bfloat16:
                    b3_check(ext, w, where)
                else:
                    ok, err = within(conv3x3(ext, w), conv3x3_plain(ext, w),
                                     1e-5, 1e-5)
                    log("kernel_check", kernel="B3", shape=list(ext.shape),
                        cout=co, served_by=where, dtype="fp32",
                        max_abs_err=err, rtol=1e-5, atol=1e-5, ok=ok)
                    if not ok:
                        raise AssertionError(f"B3 fp32 at {list(ext.shape)}:"
                                             f" max abs err {err}")
                got = torch.cat(spatial._narrow_conv(group, blocks,
                                                     [w] * n, dt), dim=2)
                equal = torch.equal(got, conv3x3(x, w))
                log("spatial_b3", shards=n, shape=list(x.shape), cout=co,
                    served_by=served_by, dtype=str(dt).split(".")[-1],
                    cropped_rows_bit_equal=equal)
                if not equal:
                    raise AssertionError(f"B3 on {n} shards at "
                                         f"{list(x.shape)} ({dt}): the "
                                         "cropped rows differ from the "
                                         "dense kernel's")
                del x, blocks, ext, got


def check_spatial_kernels(dev, gen) -> None:
    """The kernels at the shapes the row-sharded serving path gives them:
    B3 at 8 x 1024^2 over 2 and 4 shards (``spatial_b3_check``), and B4's
    stream route at each family's int8 sites on a shard of 4 x 256^2
    over 2, code for code."""
    spatial_b3_check(dev, gen, SP_BATCH, 2 * SP_LR, SP_SHARDS,
                     "spatial shard")
    n, seen = SP_SMALL_SHARDS, set()
    for family in SP_FAMILIES:
        for site, (b, c, h, w), slope in zoo_quant_sites(
                family, SP_SMALL, SP_SMALL_LR, BASE_FILTERS):
            shard = (b, c, h // n, w)
            if (shard, slope) not in seen:
                seen.add((shard, slope))
                b4_site_check(f"{family} {site} (spatial shard)", shard,
                              slope, dev, gen)


def _sp_engines(dev, cfg, params, lr, hr, smi: str) -> dict:
    """The full-width unet at 8 x 512^2 over 2 and 4 shards of one card,
    fp32 and bf16, against the one-device engine on the same batch:
    fp32 within rtol 1e-4, atol 3e-5; bf16 within 0.1 dB PSNR of the
    dense bf16 output against the HR truth and no more than 0.1 dB below
    it against the fp32 truth; B3 2n launches a forward and no other
    kernel; ms a batch beside the dense engine's."""
    res, launches = {}, {}
    truth = None
    for bf16 in (False, True):
        name = "bf16" if bf16 else "fp32"
        dense = InferenceEngine(cfg, params, bf16=bf16, device=dev)
        want = dense.upscale_batch(lr)
        if not bf16:
            truth = want
        dense_ms = cuda_ms(lambda: dense.upscale_batch(lr), iters=3,
                           warmup=0)
        for n in SP_SHARDS:
            eng = InferenceEngine(cfg, params, bf16=bf16,
                                  devices=[dev] * n, spatial_shards=n)
            eng.upscale_batch(lr[:1])                    # warm
            kernels.reset_launch_counts()
            got = eng.upscale_batch(lr)
            counts = _sp_counts()
            _add(launches, counts)
            if bf16:
                q = {"psnr_db": _psnr_db(got, hr),
                     "dense_psnr_db": _psnr_db(want, hr),
                     "vs_fp32_db": _psnr_db(got, truth),
                     "dense_vs_fp32_db": _psnr_db(want, truth)}
                ok = abs(q["psnr_db"] - q["dense_psnr_db"]) <= 0.1 and \
                    q["vs_fp32_db"] >= q["dense_vs_fp32_db"] - 0.1
                gate = q
            else:
                ok, err = within(torch.from_numpy(got), torch.from_numpy(
                    want), 1e-4, 3e-5)
                gate = {"max_abs_err": err, "rtol": 1e-4, "atol": 3e-5}
            ms = cuda_ms(lambda: eng.upscale_batch(lr), iters=3, warmup=0)
            want_counts = {"conv3x3": 2 * n}
            log("spatial_engine", dtype=name, shards=n,
                devices=[str(dev)] * n, batch=SP_BATCH, lr=[SP_LR, SP_LR],
                launches=counts, expected=want_counts, ok=ok, **gate,
                spatial_ms=ms, one_device_ms=dense_ms, card=smi,
                timing="CUDA events around 3 upscale_batch calls, upload "
                       "and fetch included; one card, not representative")
            if not ok or counts != want_counts:
                raise AssertionError(f"spatial engine ({name}, {n} shards):"
                                     f" {gate}, launches {counts}")
            res[f"{name}_{n}"] = {"spatial_ms": ms, "one_device_ms": dense_ms}
    return {"launches": launches, "ms": res}


def _family_params(family: str, params) -> tuple:
    if family == "unet":
        return ModelConfig(base_filters=BASE_FILTERS), params
    cfg = ModelConfig(model_type=family, base_filters=BASE_FILTERS,
                      num_blocks=EDSR_BLOCKS)
    return cfg, build_model(cfg, generator=torch.Generator().manual_seed(
        1)).state_dict()


def _sp_int8(dev, params, lr) -> dict:
    """Each family on 4 x 256^2 over 2 shards: calibrated on the batch, a
    sidecar frozen, spatial and dense int8 served from it (unet and
    unet_tpu within the quality contract against the fp32 truth, edsr
    and simple bit-equal), B4 one stream launch a site and shard and no
    other kernel; the fp32 calibration forward's amax against the dense
    ``calib_amax`` within rtol 1e-5, atol 1e-6 at every site."""
    from mri_superresolution_torch.parallel import spatial
    n = SP_SMALL_SHARDS
    launches, out = {}, {}
    x = torch.from_numpy(lr[..., None]).to(dev)
    for family in SP_FAMILIES:
        cfg, sd = _family_params(family, params)
        sd = {k: v.to(dev) for k, v in sd.items()}
        path = SP_DIR / f"{family}.calib.json"
        quant_forward.save_scales(str(path), quant_forward.calibrate(
            sd, [x], family, torch.bfloat16), family)
        kw = {"quant": "int8", "quant_calib_path": str(path)}
        dense = InferenceEngine(cfg, sd, device=dev, **kw)
        sp = InferenceEngine(cfg, sd, devices=[dev] * n, spatial_shards=n,
                             **kw)
        want = dense.upscale_batch(lr)
        sp.upscale_batch(lr[:1])                         # warm
        kernels.reset_launch_counts()
        stream = leaky_quantize.stream_launches
        got = sp.upscale_batch(lr)
        counts = _sp_counts()
        stream = leaky_quantize.stream_launches - stream
        _add(launches, counts)
        n_sites = len(quant_forward.quant_sites(sd, family))
        want_counts = {"leaky_quantize": n * n_sites}
        if family in ("edsr", "simple"):
            gate = {"bit_equal": bool(np.array_equal(got, want))}
            ok = gate["bit_equal"]
        else:
            truth = InferenceEngine(cfg, sd, bf16=False,
                                    device=dev).upscale_batch(lr)
            gate = _int8_quality(got, want, truth)
            ok = gate["ok"]
        sites = sorted(quant_forward.amax_template(sd, family))
        mesh = spatial.make_spatial_mesh(1, n, [dev] * n)
        with torch.inference_mode():
            _, amax = spatial.build_spatial_calib_forward_raw(
                mesh, (SP_SMALL_LR, SP_SMALL_LR), sites, family,
                torch.float32)(sd, x)
            dense_amax = quant_forward.calib_amax(sd, x, family,
                                                  torch.float32)
        amax_err = max(float(((amax[k] - dense_amax[k]).abs() / (
            1e-6 + 1e-5 * dense_amax[k].abs())).max()) for k in sites)
        ok = ok and amax_err <= 1.0 and counts == want_counts and \
            stream == n * n_sites
        log("spatial_int8", family=family, shards=n, batch=SP_SMALL,
            lr=[SP_SMALL_LR, SP_SMALL_LR], launches=counts,
            expected=want_counts, stream_launches=stream,
            quant_batches=sp._quant_batches, calib_amax_err_over_tol=amax_err,
            ok=ok, gate=gate)
        if not ok or sp._quant_batches != {"int8": 2, "bf16": 0}:
            raise AssertionError(f"spatial int8 ({family}): {gate}, amax "
                                 f"err/tol {amax_err}, launches {counts}, "
                                 f"stream {stream}, {sp._quant_batches}")
        out[family] = gate
    return {"launches": launches, "checks": out}


def _sp_stream_tta(dev, cfg, params, lr, hr) -> dict:
    """Streaming calibration on the spatial engine (calibrates on the
    batch, freezes, re-serves it int8; the dense engine's quality
    contract), and the bf16 TTA ensemble over 2 shards within the bf16
    budget of the dense ensemble."""
    n = SP_SMALL_SHARDS
    kw = {"quant": "int8", "quant_calib_slices": SP_SMALL}
    sp = InferenceEngine(cfg, params, devices=[dev] * n, spatial_shards=n,
                         **kw)
    dense = InferenceEngine(cfg, params, device=dev, **kw)
    y_sp, y_d = sp.upscale_batch(lr), dense.upscale_batch(lr)
    truth = InferenceEngine(cfg, params, bf16=False,
                            device=dev).upscale_batch(lr)
    stream = {**_int8_quality(y_sp, y_d, truth),
              "quant_batches": sp._quant_batches,
              "summary": sp.quant_summary()}
    stream["ok"] = stream["ok"] and sp._quant_batches == {"int8": 1,
                                                          "bf16": 0}
    tta_sp = InferenceEngine(cfg, params, devices=[dev] * n,
                             spatial_shards=n, tta=True).upscale_batch(lr)
    tta_d = InferenceEngine(cfg, params, device=dev,
                            tta=True).upscale_batch(lr)
    tta = _budget_quiet(_quality(tta_sp, hr, dev), _quality(tta_d, hr, dev))
    log("spatial_stream_tta", shards=n, batch=SP_SMALL, streaming=stream,
        tta=tta)
    if not (stream["ok"] and tta["ok"]):
        raise AssertionError(f"spatial streaming calibration {stream}, "
                             f"TTA {tta}")
    return {"streaming": stream, "tta": tta}


def _kill_group(proc) -> None:
    """Stop a process started in a session of its own, with its
    children."""
    if proc.poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(30)


def _sp_volume(dev) -> dict:
    """``cli.infer_volume`` in this process on a 128 x 128 x 8 int16
    phantom volume, with and without ``--num_devices 2 --spatial_shards
    2``: both exit 0, within the bf16 budget of each other against the
    2x truth."""
    h, w, k = SP_VOL
    lr = phantom_batch(np.random.default_rng(4), k, h)
    gt = phantom_batch(np.random.default_rng(4), k, 2 * h)
    nifti.save(str(SP_DIR / "vol.nii"), np.transpose(
        np.round(lr * 2000.0).astype(np.int16), (1, 2, 0)),
        zooms=(1.0, 1.0, 3.0), scl_slope=VOL_SLOPE)
    outs, runs = {}, {}
    for name, flags in (("dense", []), ("spatial", [
            "--num_devices", "2", "--spatial_shards", "2"])):
        out = SP_DIR / f"sr_{name}.nii"
        runs[name] = _serve_volume([
            "--input", str(SP_DIR / "vol.nii"), "--output", str(out),
            "--checkpoint_dir", str(SP_DIR / "ckpt"), "--batch_size", "4",
            *flags])
        data, hdr = nifti.load(str(out))
        outs[name] = np.transpose(data, (2, 0, 1))
    d = _budget_quiet(_quality(outs["spatial"], gt, dev),
                      _quality(outs["dense"], gt, dev))
    ok = d["ok"] and runs["dense"]["rc"] == runs["spatial"]["rc"] == 0 and \
        outs["spatial"].shape == (k, 2 * h, 2 * w)
    log("spatial_volume_cli", shape=list(SP_VOL), runs=runs, budget=d,
        ok=ok)
    if not ok:
        raise AssertionError(f"infer_volume --spatial_shards 2: {runs}, {d}")
    return {"launches": runs["spatial"]["launches"]}


SPATIAL_BACKGROUND = r"""
import json, subprocess, sys, time
a = json.loads(sys.argv[1])
t = time.perf_counter()
e = subprocess.run(a["export"], capture_output=True, text=True)
out = {"export_rc": e.returncode, "export_stdout": e.stdout[-2000:],
       "export_stderr": e.stderr[-3000:],
       "export_s": time.perf_counter() - t}
if e.returncode == 0:
    t = time.perf_counter()
    c = subprocess.run(a["client"], capture_output=True, text=True)
    out.update(client_rc=c.returncode, client_stdout=c.stdout[-4000:],
               client_stderr=c.stderr[-3000:],
               client_s=time.perf_counter() - t)
print(json.dumps(out))
"""


def spatial_start(cfg, params):
    """The spatial phase's checkpoint, and its export CLI followed by the
    fresh process that serves the artifact, started in the background:
    tracing the row-sharded program takes a minute of host time, which
    the phases before it cover."""
    shutil.rmtree(SP_DIR, ignore_errors=True)
    (SP_DIR / "ckpt").mkdir(parents=True)
    ckpt.save_checkpoint(str(SP_DIR / "ckpt" / "final_model_unet"), params,
                         meta={"config": {"model": dataclasses.asdict(cfg)}})
    art = SP_DIR / "spatial.mrisrt"
    spec = {"path": str(art), "devices": 2, "batch": SP_SMALL,
            "size": SP_SMALL_LR, "out": str(SP_DIR / "art.npy")}
    chain = {"export": [
        sys.executable, "-m", "mri_superresolution_torch.cli.export_serving",
        "--checkpoint_dir", str(SP_DIR / "ckpt"), "--out", str(art),
        "--shapes", f"{SP_SMALL_LR}x{SP_SMALL_LR}", "--spatial_shards", "2",
        "--spatial_devices", "2", "--spatial_batch", str(SP_SMALL)],
        "client": [sys.executable, "-c", SPATIAL_CLIENT, json.dumps(spec)]}
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    proc = subprocess.Popen(
        [sys.executable, "-c", SPATIAL_BACKGROUND, json.dumps(chain)],
        cwd=str(SP_DIR), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    # stopped, with the export or client it runs, however the script ends
    atexit.register(_kill_group, proc)
    return {"art": art, "proc": proc}


def _sp_artifact(bg: dict, want: np.ndarray) -> None:
    """The background export and client's results: the export's line, and
    the client's output bit-equal to the spatial engine's, with no model
    code imported and B3 2 launches a shard."""
    out, err = bg["proc"].communicate(timeout=600)
    res = json.loads(out.strip().splitlines()[-1]) if out.strip() else {}
    if res.get("export_rc") != 0 or "spatial=2" not in res.get(
            "export_stdout", "") or res.get("client_rc") != 0:
        raise AssertionError(f"spatial export and client: {res or err}")
    client = json.loads(res["client_stdout"].strip().splitlines()[-1])
    got = np.load(SP_DIR / "art.npy")
    ok = np.array_equal(got, want) and not client["model_modules"] \
        and client["launches"] == {"conv3x3": 2 * SP_SMALL_SHARDS}
    log("spatial_artifact",
        export_line=res["export_stdout"].strip().splitlines()[-1],
        mib=os.path.getsize(bg["art"]) / 2 ** 20, client=client,
        export_s=res["export_s"], client_process_s=res["client_s"],
        bit_equal=bool(np.array_equal(got, want)), ok=ok)
    if not ok:
        raise AssertionError(f"spatial artifact: {client}, bit-equal "
                             f"{np.array_equal(got, want)}")


def spatial_path(dev, cfg, params, bg: dict, smi: str) -> dict:
    """Row-sharded serving on one card named several times: see the
    module's phase 15. ``bg``: :func:`spatial_start`'s background
    export; ``smi``: the card's name and power limit, beside the
    times."""
    t0 = time.perf_counter()
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    # the daemon comes up on the host while the card runs the checks
    daemon_log = open(SP_DIR / "serve.log", "w")
    daemon = subprocess.Popen([
        sys.executable, "-m", "mri_superresolution_torch.cli.serve",
        "--checkpoint_dir", str(SP_DIR / "ckpt"), "--port", str(port),
        "--num_devices", "2", "--spatial_shards", "2", "--max_batch", "2"],
        cwd=str(SP_DIR), env=dict(os.environ, PYTHONPATH=str(
            Path(__file__).resolve().parent)), stdout=daemon_log,
        stderr=daemon_log)
    launches, times = {}, {}

    def lap(name, t):
        times[name] = time.perf_counter() - t
        return time.perf_counter()

    try:
        t = time.perf_counter()
        check_spatial_kernels(dev, torch.Generator(device=dev).manual_seed(9))
        t = lap("kernel_checks", t)
        small = phantom_batch(np.random.default_rng(0), SP_SMALL, SP_SMALL_LR)
        small_hr = phantom_batch(np.random.default_rng(0), SP_SMALL,
                                 2 * SP_SMALL_LR)
        lr = phantom_batch(np.random.default_rng(0), SP_BATCH, SP_LR)
        hr = phantom_batch(np.random.default_rng(0), SP_BATCH, 2 * SP_LR)
        engines = _sp_engines(dev, cfg, params, lr, hr, smi)
        _add(launches, engines["launches"])
        t = lap("engines", t)
        int8 = _sp_int8(dev, params, small)
        _add(launches, int8["launches"])
        t = lap("int8", t)
        extra = _sp_stream_tta(dev, cfg, params, small, small_hr)
        t = lap("streaming_tta", t)
        volume = _sp_volume(dev)
        t = lap("volume_cli", t)
        sp_eng = InferenceEngine(cfg, params, devices=[dev] * 2,
                                 spatial_shards=2)
        # each against the engine at its own batch: cuDNN may sum in
        # another order at another batch size
        want, want2 = sp_eng.upscale_batch(small), sp_eng.upscale_batch(
            small[:2])
        # the daemon: one /upscale of a stack of 2
        deadline = time.monotonic() + 180
        while True:
            try:
                health = json.loads(_http(base, "/healthz", timeout=5))
                break
            except (urllib.error.URLError, ConnectionError):
                if daemon.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(
                        f"serve --spatial_shards 2 did not come up (exit "
                        f"{daemon.poll()}); see {SP_DIR}/serve.log")
                time.sleep(0.25)
        served = _from_npy(_http(base, "/upscale", _npy(small[:2])))
        daemon.send_signal(signal.SIGTERM)
        rc = daemon.wait(120)
        served_ok = rc == 0 and np.array_equal(served, want2)
        log("spatial_serve_cli", health=health, sigterm_exit=rc,
            bit_equal=bool(np.array_equal(served, want2)), ok=served_ok)
        if not served_ok:
            raise AssertionError(f"serve --spatial_shards 2: exit {rc}, "
                                 "answer not the engine's")
        t = lap("serve_cli", t)
        _sp_artifact(bg, want)
        lap("artifact_wait", t)
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait(30)
        daemon_log.close()
        _kill_group(bg["proc"])
    seconds = time.perf_counter() - t0
    log("spatial_path", seconds=seconds, times=times, launches=launches,
        volume_launches=volume["launches"])
    return {"launches": launches, "engines": engines["ms"],
            "int8": int8["checks"], "seconds": seconds, **extra}


# the row-sharded training phase: two gloo ranks on one card
SPT_DIR = SCALES_PATH.parent / "spatial_train"
SPT_TIME_STEPS = 3
SPT_NOTE = "gloo, two ranks on one card, not representative"
# the bf16 rank group against the in-process group: each gradient's gap
# in bf16 ulps of its largest magnitude (the two round the backward's
# bf16 sums at different places; on the CPU at base filters 16 a healthy
# pair reads 3.9, an fp16 round trip in the sum's backward 18, a halo
# backward that drops one direction 175)
SPT_BF16_ULPS = 8.0


def _spt_cli_argv() -> list:
    """The train CLI's flags of the phase: ``--num_devices 2
    --spatial_shards 2``, one epoch on the training phase's pairs."""
    ck = SPT_DIR / "cli"
    return ["--full_res_dir", str(TRAIN_DIR / "hr"),
            "--low_res_dir", str(TRAIN_DIR / "lr"),
            "--base_filters", str(BASE_FILTERS),
            "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
            "--seed", str(TRAIN_SEED), "--checkpoint_dir", str(ck),
            "--log_dir", str(ck / "logs"), "--num_devices", "2",
            "--spatial_shards", "2"]


def _spt_cli(dev) -> dict:
    """The train CLI's run (in the step's ranks, after the step): its
    rank 0's protocol and log, and its checkpoint served by the
    one-device engine."""
    ck = SPT_DIR / "cli"
    log_text = (ck / "logs" / "training.log").read_text() \
        if (ck / "logs" / "training.log").exists() else ""
    final = ck / "final_model_unet.ckpt"
    summaries = []
    for ln in (SPT_DIR / "ranks.out").read_text(errors="replace").splitlines():
        if ln.startswith("{") and ln.endswith('"type": "epoch_summary"}'):
            summaries.append(json.loads(ln))
    served = None
    if final.exists():
        eng = load_engine(InferConfig(checkpoint_path=str(final)),
                          device=dev)
        served = eng.upscale_batch(phantom_batch(np.random.default_rng(4), 2,
                                                 TRAIN_LR))
    ok = bool(served is not None and served.shape ==
              (2, 2 * TRAIN_LR, 2 * TRAIN_LR) and np.isfinite(served).all()
              and "Spatially-sharded training: (1 data x 2 space) mesh"
              in log_text and len(summaries) == 1
              and np.isfinite(summaries[0]["train_loss"]))
    res = {"epoch_summary": summaries,
           "served_shape": None if served is None else list(served.shape),
           "ok": ok}
    log("spatial_train_cli", **res)
    if not ok:
        raise AssertionError(f"the spatial train CLI on two ranks: {res}; "
                             f"see {SPT_DIR}/ranks.err")
    return res


def bf16_ulps_of_max(got: dict, want: dict) -> float:
    """The largest gap between two gradient trees, each tensor's in bf16
    ulps (2^(e - 7) for a largest magnitude in [2^e, 2^(e + 1))) of its
    largest magnitude in ``want``."""
    worst = 0.0
    for k, w in want.items():
        m = float(w.abs().max())
        err = float((got[k].double() - w.double()).abs().max())
        if m == 0.0:
            worst = max(worst, math.inf if err else 0.0)
        else:
            worst = max(worst, err / 2.0 ** (math.floor(math.log2(m)) - 7))
    return worst


def spatial_train_path(dev, smi: str) -> dict:
    """Row-sharded training on one card: see the module's phase 16."""
    shutil.rmtree(SPT_DIR, ignore_errors=True)
    SPT_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    spatial_b3_check(dev, torch.Generator(device=dev).manual_seed(10),
                     TRAIN_BATCH, 2 * TRAIN_LR, (2,), "spatial training shard")
    sd = build_model(ModelConfig(base_filters=BASE_FILTERS),
                     generator=torch.Generator().manual_seed(TRAIN_SEED)
                     ).state_dict()
    batch = {k: v.cpu().numpy() for k, v in
             _train_batch("cpu", TRAIN_BATCH, TRAIN_LR).items()}

    def case(name, dtype, **kw):
        return {"name": name, "model": {"base_filters": BASE_FILTERS},
                "state_dict": sd, "batch": batch, "dtype": dtype,
                "mesh": (1, 2), "lr": 1e-4, "weight_decay": 1e-5, **kw}

    cases = [case("fp32", "float32"),
             case("bf16", "bfloat16", time_steps=SPT_TIME_STEPS)]
    # the train CLI's rank runs in the same ranks after the step cases
    torch.save({"cases": cases, "allow_tf32": False,
                "train_argv": _spt_cli_argv()}, SPT_DIR / "spec.pt")
    # the protocol's lines apart from the logs, which would split them
    with _fds_to(SPT_DIR / "ranks.out", SPT_DIR / "ranks.err"):
        rc = multihost_mod.launch(
            "mri_superresolution_torch.tools.sp_step:run_rank",
            [str(SPT_DIR / "spec.pt"), str(SPT_DIR)], [dev, dev],
            f"127.0.0.1:{multihost_mod.free_port()}", 2, backend="gloo")
    if rc != 0:
        raise AssertionError(f"the spatial step's two gloo ranks exited "
                             f"{rc}; see {SPT_DIR}/ranks.err")
    ranks = sp_step.rank_results(cases, str(SPT_DIR), 2)
    t1 = time.perf_counter()
    inproc = {c["name"]: sp_step.run_mesh(c, dev) for c in cases}
    dense = {c["name"]: dp_step.run_case(c, dev) for c in cases}
    seconds = {"ranks": t1 - t0, "references": time.perf_counter() - t1}
    r32, d32 = ranks["fp32"][0], dense["fp32"]
    gates = {
        "fp32_loss_rel": abs(r32["metrics"]["loss"] - d32["metrics"]["loss"])
        / abs(d32["metrics"]["loss"]),
        "fp32_grad_max_abs": sp_step.max_abs(r32["grads"], d32["grads"]),
        "bf16_loss_rel": abs(ranks["bf16"][0]["metrics"]["loss"]
                             - dense["bf16"]["metrics"]["loss"])
        / abs(dense["bf16"]["metrics"]["loss"]),
        "fp32_vs_in_process_grad_max_abs": sp_step.max_abs(
            r32["grads"], inproc["fp32"]["grads"]),
        "bf16_vs_in_process_grad_max_abs": sp_step.max_abs(
            ranks["bf16"][0]["grads"], inproc["bf16"]["grads"]),
        "bf16_vs_in_process_grad_ulps_of_max": bf16_ulps_of_max(
            ranks["bf16"][0]["grads"], inproc["bf16"]["grads"])}
    checks = {
        "fp32_vs_dense": gates["fp32_loss_rel"] <= 1e-5
        and gates["fp32_grad_max_abs"] <= 1e-4,
        "bf16_vs_dense": gates["bf16_loss_rel"] <= 1e-3,
        "metrics_equal_in_process": all(
            ranks[n][0]["metrics"] == inproc[n]["metrics"] for n in ranks),
        "fp32_grads_in_process": gates["fp32_vs_in_process_grad_max_abs"]
        <= 1e-6,
        "bf16_grads_in_process": gates["bf16_vs_in_process_grad_ulps_of_max"]
        <= SPT_BF16_ULPS,
        "ranks_equal": all(sp_step.same_bits(ranks[n][0]["params"],
                                             ranks[n][1]["params"])
                           for n in ranks),
        "rank_launches": all(ranks[n][r]["launches"] == {"conv3x3": 2}
                             for n in ranks for r in (0, 1)),
        "in_process_launches": all(inproc[n]["launches"] == {"conv3x3": 4}
                                   for n in inproc)}
    launches = {}
    for n in ranks:
        for r in (0, 1):
            _add(launches, ranks[n][r]["launches"])
    ms = {"rank_step_ms": [ranks["bf16"][r]["step_ms"] for r in (0, 1)],
          "in_process_step_ms": inproc["bf16"]["step_ms"],
          "one_device_step_ms": dense["bf16"]["step_ms"]}
    log("spatial_train_step", ranks=2, mesh=[1, 2], device=str(dev),
        batch=TRAIN_BATCH, lr=TRAIN_LR, backend=ranks["fp32"][0]["backend"],
        **gates, **checks, launches=launches,
        dense_launches=dense["bf16"]["launches"], **ms, seconds=seconds,
        timing=f"{SPT_NOTE}: host clock around {SPT_TIME_STEPS} bf16 steps "
               f"after one, synchronized; {smi}")
    if not all(checks.values()):
        raise AssertionError(f"spatial training step: {checks}, {gates}")
    cli = _spt_cli(dev)
    seconds = time.perf_counter() - t0
    log("spatial_train_path", seconds=seconds, launches=launches)
    return {"launches": launches, "ms": ms, "cli": cli, "seconds": seconds}


# --------------------------------------------- EMA, resume and streaming

EMA_DIR = SCALES_PATH.parent / "ema"
# the EMA run's decay and its step checkpoints (step 3 is epoch 0's
# batch 3 of 4); the host recompute: steps and its gate, relative to each
# tensor's largest magnitude
EMA_DECAY, EMA_SAVE_EVERY = 0.9, 3
EMA_RECOMPUTE_STEPS, EMA_RECOMPUTE_RTOL = 10, 1e-6


class _Preempted(Exception):
    """Raised from the trainer's progress callback: a simulated
    preemption."""


def _params_sha(sd: dict) -> str:
    """SHA-256 over a state_dict's names and fp32 bytes, in sorted order."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _ckpt_arrays(path: str) -> dict:
    """Every array a checkpoint holds, flat: its params, its extras'
    trees (``raw_params``) and Adam's count and moments."""
    params, opt, _, extras = ckpt.load_checkpoint(path, return_extras=True)
    out = {f"params/{k}": v for k, v in params.items()}
    for name, tree in extras.items():
        out.update({f"{name}/{k}": v for k, v in tree.items()})
    if opt is not None:
        out["opt/count"] = torch.tensor(opt["count"])
        for m in ("mu", "nu"):
            out.update({f"opt/{m}/{k}": v for k, v in opt[m].items()})
    return out


def _train_gate(name: str, run: dict) -> None:
    """A train CLI run's launches against its expected counts, all of
    B1's backward on the one-pass route."""
    want = run["expected"]
    ok = run["launches"] == want and \
        run["backward_onepass"] == want["group_norm_leaky_backward"]
    log("ema_train", run=name, seconds=run["seconds"], steps=run["steps"],
        val_batches=run["vals"], launches=run["launches"], expected=want,
        backward_onepass=run["backward_onepass"], ok=ok)
    if not ok:
        raise AssertionError(f"{name}: launches {run['launches']} (B1 "
                             f"backward one-pass {run['backward_onepass']}),"
                             f" expected {want}")


def ema_path(dev, lr, hr, trained: dict) -> dict:
    """``--ema_decay``, the mid-epoch resume and streaming through the
    train CLI at the training phase's pairs, width and epochs: (a) EMA
    0.9 with step checkpoints every 3 steps, its ``raw_params`` the
    training phase's final params by SHA-256 (EMA never feeds back), its
    served params apart; the same with ``--augmentation``, and again
    preempted at epoch 1's first batch and resumed from its step
    checkpoint (mid-epoch 0): every array of the two final checkpoints
    the same bytes; (c) ``--streaming on``, its final checkpoint the
    training phase's bytes; (d) the EMA of 10 steps at 8 x 128^2 against
    a float64 recompute on the host, fp32 (TF32 off) and bf16; (e) a step
    with EMA launches what a step without it does; (f) the EMA checkpoint
    served on the card and on the CPU port within the bf16 budget."""
    start = time.perf_counter()
    shutil.rmtree(EMA_DIR, ignore_errors=True)
    totals = dict.fromkeys(kernels.launch_counts(), 0)
    ema = ("--ema_decay", str(EMA_DECAY), "--save_every_steps",
           str(EMA_SAVE_EVERY))
    aug = (*ema, "--augmentation")

    # (a) the live weights under EMA are the training phase's
    plain = _train_cli(EMA_DIR / "plain", ema, epochs=TRAIN_EPOCHS)
    _train_gate("ema", plain)
    params, _, _, extras = ckpt.load_checkpoint(plain["final"],
                                                return_extras=True)
    raw = extras["raw_params"]
    train_sha = _params_sha(ckpt.load_checkpoint(
        str(TRAIN_DIR / "ckpt" / "final_model_unet.ckpt"))[0])
    ema_gap = max(float((params[k] - raw[k]).abs().max()) for k in raw)
    ok_a = _params_sha(raw) == train_sha and ema_gap > 0.0
    log("ema_raw_params", raw_params_sha256=_params_sha(raw),
        train_path_sha256=train_sha, params_sha256=_params_sha(params),
        max_abs_params_minus_raw=ema_gap, ok=ok_a)
    if not ok_a:
        raise AssertionError(f"the EMA run's raw_params are not the "
                             f"training phase's final params, or its "
                             f"served params do not differ from them "
                             f"({ema_gap})")
    _add(totals, plain["launches"])

    # (b) with augmentation: uninterrupted, then preempted and resumed
    full = _train_cli(EMA_DIR / "aug", aug, epochs=TRAIN_EPOCHS)
    _train_gate("ema_augmentation", full)
    _add(totals, full["launches"])
    ck = EMA_DIR / "resumed"

    def preempt(epoch, batch_idx, loss):
        if epoch == 1:
            raise _Preempted

    cfg = train_cli.config_from_args(train_cli.parse_args(
        _train_argv(ck, aug, TRAIN_EPOCHS)))
    kernels.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            trainer.train(cfg, progress_cb=preempt, device=dev)
    except _Preempted:
        pass
    else:
        raise AssertionError("the EMA run was not preempted")
    torch.cuda.synchronize()
    cut = kernels.launch_counts()
    cut_bwd = group_norm_leaky_backward.onepass_launches
    step_meta = ckpt.read_meta(str(ck / "step_model_unet.ckpt"))
    resumed = _train_cli(ck, (*aug, "--resume"), epochs=TRAIN_EPOCHS)
    mid_epoch = "mid-epoch" in json.dumps(resumed["by_type"])
    # the two runs' launches: epoch 0 and epoch 1's first step before the
    # preemption; epoch 0 from its step checkpoint's cursor, and epoch 1
    # after it
    per_epoch = full["steps"] // TRAIN_EPOCHS
    steps = (per_epoch + 1) + (per_epoch - EMA_SAVE_EVERY) + \
        (TRAIN_EPOCHS - 1) * per_epoch
    vals = 1 + TRAIN_EPOCHS
    pair = {k: cut.get(k, 0) + v for k, v in resumed["launches"].items()}
    want = dict.fromkeys(pair, 0)
    want.update(group_norm_leaky=20 * (steps + vals),
                group_norm_leaky_backward=20 * steps,
                conv3x3=2 * (steps + vals), ssim_per_sample=steps + vals)
    bwd_onepass = cut_bwd + resumed["backward_onepass"]
    a, b = _ckpt_arrays(full["final"]), _ckpt_arrays(resumed["final"])
    differ = sorted(k for k in a if k not in b or not torch.equal(a[k], b[k]))
    ok_b = (sorted(a) == sorted(b) and not differ and mid_epoch
            and (step_meta.get("epoch"), step_meta.get("batch_cursor"))
            == (0, EMA_SAVE_EVERY) and pair == want
            and bwd_onepass == 20 * steps
            and not (ck / "step_model_unet.ckpt").exists())
    log("ema_resume", arrays=len(a), differing=differ[:8],
        step_checkpoint={k: step_meta.get(k) for k in
                         ("epoch", "batch_cursor", "step")},
        resumed_mid_epoch=mid_epoch, final_sha256={
            "uninterrupted": _params_sha(a), "resumed": _params_sha(b)},
        launches=pair, expected=want, backward_onepass=bwd_onepass,
        seconds={"uninterrupted": full["seconds"],
                 "resumed": resumed["seconds"]}, ok=ok_b)
    if not ok_b:
        raise AssertionError(f"the preempted and resumed EMA run differs "
                             f"from the uninterrupted one: arrays "
                             f"{differ[:8]}, step checkpoint at epoch "
                             f"{step_meta.get('epoch')} batch "
                             f"{step_meta.get('batch_cursor')}, "
                             f"mid-epoch {mid_epoch}, launches {pair} "
                             f"against {want}")
    _add(totals, pair)

    # (c) streaming gives the in-memory loader's checkpoint
    stream = _train_cli(EMA_DIR / "streaming", ("--streaming", "on"),
                        epochs=TRAIN_EPOCHS)
    _train_gate("streaming", stream)
    _add(totals, stream["launches"])
    got = _ckpt_digests(EMA_DIR / "streaming")
    streamed = "Streaming data loading" in json.dumps(stream["by_type"])
    ok_c = streamed and got["final_model_unet"] == \
        trained["digests"]["final_model_unet"]
    log("streaming_train", digests=got, train_path=trained["digests"],
        streaming_logged=streamed, seconds=stream["seconds"],
        in_memory_seconds=trained["seconds"], ok=ok_c)
    if not ok_c:
        raise AssertionError(f"the --streaming on run's final checkpoint "
                             f"{got} is not the training phase's "
                             f"{trained['digests']} (streaming {streamed})")

    # (d) the EMA against a float64 recompute on the host
    for dtype in (torch.float32, torch.bfloat16):
        r, _, counts, _ = _counted_run(lambda: ema_quality.ema_recompute_gap(
            dev, dtype, steps=EMA_RECOMPUTE_STEPS, batch=TRAIN_BATCH,
            lr_hw=TRAIN_LR, decay=EMA_DECAY, base_filters=BASE_FILTERS),
            totals)
        ok_d = r["worst_rel_gap"] <= EMA_RECOMPUTE_RTOL and \
            counts["group_norm_leaky_backward"] == 20 * EMA_RECOMPUTE_STEPS
        log("ema_recompute", batch=TRAIN_BATCH, lr=[TRAIN_LR, TRAIN_LR],
            **r, gate=f"each tensor within {EMA_RECOMPUTE_RTOL} of its "
            f"largest magnitude", launches=counts, ok=ok_d)
        if not ok_d:
            raise AssertionError(f"the EMA ({dtype}) is off its float64 "
                                 f"recompute: {r}")

    # (e) the EMA update launches no kernel of the port
    model = build_model(ModelConfig(base_filters=BASE_FILTERS),
                        dtype=torch.bfloat16, generator=torch.Generator(
                            ).manual_seed(TRAIN_SEED)).to(dev)
    state = trainer.TrainState(
        model, trainer.make_optimizer(model.parameters(), 1e-4, 1e-5), 0,
        {k: p.detach().clone() for k, p in model.named_parameters()})
    step = trainer.build_train_step(CombinedLoss(LossConfig()),
                                    ema_decay=EMA_DECAY)
    batch = _train_batch(dev, TRAIN_BATCH, TRAIN_LR)
    per_step = _step_counts(lambda: step(state, batch, 1e-4))
    _add(totals, {k: v for k, v in per_step.items() if "." not in k})
    want_step = {"group_norm_leaky": 20, "group_norm_leaky_backward": 20,
                 "group_norm_leaky_backward.onepass": 20, "conv3x3": 2,
                 "ssim_per_sample": 1}
    log("ema_step_launches", step=per_step, expected=want_step,
        ok=per_step == want_step)
    if per_step != want_step:
        raise AssertionError(f"a step with EMA launches {per_step}, "
                             f"expected {want_step}")

    # (f) the EMA checkpoint served on the card and on the CPU port
    (out, _, counts, _) = _counted_run(lambda: load_engine(
        InferConfig(checkpoint_path=plain["final"]), device=dev
    ).upscale_batch(lr[:2]), totals)
    out_cpu = load_engine(InferConfig(checkpoint_path=plain["final"]),
                          device="cpu").upscale_batch(lr[:2])
    d = _budget_quiet(_quality(out, hr[:2]), _quality(out_cpu, hr[:2]))
    ok_f = d["ok"] and counts["group_norm_leaky"] == 20 and \
        counts["conv3x3"] == 2 and bool(np.isfinite(out).all())
    log("ema_serve", checkpoint=plain["final"], slices=2, launches=counts,
        max_abs_diff=float(np.abs(out - out_cpu).max()), **{**d, "ok": ok_f})
    if not ok_f:
        raise AssertionError(f"the EMA checkpoint served on the card and "
                             f"on the CPU port: {d}, launches {counts}")
    seconds = time.perf_counter() - start
    log("ema_path", seconds=seconds, ema_run_seconds=plain["seconds"],
        launches=totals)
    return {"launches": totals, "seconds": seconds}


# ------------------------------------------------------ the daemon soak

# tools/soak_server.py at the serving phase's width and size (256^2 ->
# 512^2, base filters 32), its JAX defaults otherwise, for 30 s
SOAK_ARGV = ["--seconds", "30", "--slice_clients", "6", "--volume_clients",
             "2", "--hw", str(LR), "--batch", "16", "--vol_slices", "24",
             "--base_filters", str(BASE_FILTERS)]


def soak_path(dev) -> dict:
    """The port's ``tools/soak_server`` logic on the card: 6 slice and 2
    volume clients against the raw int16 daemon for 30 s; its five books
    checks; B1 20 (one-pass) and B3 2 launches an engine forward; each
    client's first response against ``upscale_batch`` on the same slices
    at the bf16 budget (an fp32 engine's output the truth), bit-equality
    logged; B1 and B3 against their plain versions at the largest padded
    batch the soak formed."""
    args = soak_server.parse_args(SOAK_ARGV)
    engine = soak_server.build_engine(args, dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    books = soak_server.run_soak(engine, args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    onepass = group_norm_leaky.onepass_launches
    s = soak_server.summary(books)
    log("soak", **s, max_pending=args.max_pending, hw=args.hw,
        base_filters=args.base_filters, vol_slices=args.vol_slices,
        clients={"slice": args.slice_clients, "volume": args.volume_clients},
        phase_seconds=seconds,
        timing="host clock; 8 client threads, the handler threads and the "
               "batcher's worker in one process")
    soak_server.check_books(books, args.max_pending)
    want = dict.fromkeys(counts, 0)
    want.update(group_norm_leaky=20 * s["batches"],
                conv3x3=2 * s["batches"])
    ok = counts == want and onepass == 20 * s["batches"]
    log("soak_launches", launches=counts, expected=want,
        onepass_launches=onepass, forwards=s["batches"], ok=ok)
    if not ok:
        raise AssertionError(f"soak launches {counts} (B1 one-pass "
                             f"{onepass}), expected {want}")

    fp32 = InferenceEngine(engine.model_cfg, {
        k: v.float() for k, v in engine.model.state_dict().items()},
        bf16=False, device=dev, normalize_inputs=True, transpose_io=True)
    worst = {"d_psnr_db": 0.0, "d_ssim": 0.0}
    equal = []
    for f in books["first"]:
        direct = soak_server.direct_output(engine, f)
        truth = soak_server.direct_output(fp32, f)
        got, want_out = f["output"], direct
        if f["kind"] == "volume":
            got, want_out, truth = (np.moveaxis(a, -1, 0) for a in
                                    (got, want_out, truth))
        scale = 1.0 / 32767.0
        d = _budget_quiet(_quality(got * scale, truth, dev),
                          _quality(want_out * scale, truth, dev))
        equal.append(bool(np.array_equal(f["output"], direct)))
        for k in worst:
            worst[k] = max(worst[k], d[k])
        log("soak_first_response", kind=f["kind"], client=f["client"],
            slices=len(got), bit_equal=equal[-1], **d)
        if not d["ok"]:
            raise AssertionError(f"soak client {f['kind']}[{f['client']}]'s "
                                 f"first response against upscale_batch: "
                                 f"{d}")
    if len(books["first"]) != args.slice_clients + args.volume_clients:
        raise AssertionError(f"{len(books['first'])} clients were served, "
                             f"of {args.slice_clients + args.volume_clients}")

    most = max(int(k) for k in s["batch_size_hist"])
    padded = min(1 << (most - 1).bit_length(), soak_server.MAX_BATCH)
    gen = torch.Generator(device=dev).manual_seed(18)
    where = f"the soak's largest padded batch ({padded})"
    b1_err = max(b1_check(*b1_inputs(shape, dev, gen), where)
                 for shape, _ in gn_sites(padded, LR, BASE_FILTERS))
    f = BASE_FILTERS
    b3_err = max(b3_check(*b3_inputs(padded, ci, co, 2 * LR, dev, gen),
                          where) for ci, co in ((f, f // 2), (f // 2, f // 2)))
    log("soak_path", seconds=seconds, slices_per_s=s["slices_per_s"],
        first_responses_bit_equal=all(equal), worst_first_response=worst,
        largest_batch=most, padded_batch=padded, b1_max_abs_err=b1_err,
        b3_max_abs_err=b3_err)
    return {"launches": counts, "summary": s, "seconds": seconds}


# ---------------------------------------------------------- harnesses

HARNESS_DIR = SCALES_PATH.parent / "harness"
HARNESS_EMA_DECAY = "0.9"
HARNESS_KEYS = {
    "ema": ["decays", "lr", "epochs", "rows"],
    "vgg": ["unet_perc0", "unet_perc0.1"],
    "edsr": ["edsr/plain", "edsr/tta", "protocol"]}


def _harness_workdir(name: str) -> Path:
    """A harness's workdir whose pairs are the extraction phase's: its
    four pair folders link to them, so it trains on them and skips
    synthesis and extraction."""
    wd = HARNESS_DIR / name
    wd.mkdir(parents=True)
    for d in ("hr_train", "lr_train", "hr_test", "lr_test"):
        os.symlink(EXTRACT_DIR / d, wd / d)
    return wd


def _tool_main(tool, wd: Path, *argv) -> dict:
    """A harness's ``main`` on ``wd`` at the extraction phase's HR size,
    its printout to ``<wd>/tool.log``."""
    with open(wd / "tool.log", "w") as f, contextlib.redirect_stdout(f):
        return tool.main(["--workdir", str(wd), "--hr_size",
                          str(EXTRACT_TARGET), *argv])


def _finite_rows(rows: dict) -> bool:
    return all(np.isfinite(r[k]) and np.isfinite(r[f"delta_{k}"])
               for r in rows.values() for k in quality.METRICS)


def _vgg19_state_dict(seed: int) -> dict:
    """A torchvision-shaped VGG19 state_dict of seeded weights: the
    ``features.*`` convs, and a classifier tensor the conversion drops."""
    rng = np.random.default_rng(seed)
    sd, in_ch = {}, 3
    for idx, (kind, arg) in enumerate(vgg_mod.layer_table()):
        if kind == "conv":
            sd[f"features.{idx}.weight"] = torch.from_numpy(
                (rng.standard_normal((arg, in_ch, 3, 3))
                 * np.sqrt(2.0 / (9 * in_ch))).astype(np.float32))
            sd[f"features.{idx}.bias"] = torch.from_numpy(
                (0.01 * rng.standard_normal(arg)).astype(np.float32))
            in_ch = arg
    sd["classifier.0.weight"] = torch.zeros(4, 8)
    return sd


def harness_path(dev, roots: dict) -> dict:
    """The port's three remaining quality harnesses through their
    ``main`` on the extraction phase's pairs (made from ``roots``' volumes)
    at a small protocol: ``ema_quality --models unet --decays 0.9 --epochs
    2``, ``vgg_quality --epochs 2``, ``edsr_convergence --epochs 4
    --patience 2``; each report's keys, finite rows, the EMA run's live
    weights the control's by SHA-256, the recorded patience; then
    ``fetch_vgg_weights --pth`` on a seeded VGG19 state_dict, its ``.npz``
    giving on the card the features of ``VGG19Features`` built from the
    same arrays. Every launch is counted."""
    start = time.perf_counter()
    shutil.rmtree(HARNESS_DIR, ignore_errors=True)
    totals = dict.fromkeys(kernels.launch_counts(), 0)
    reports, seconds = {}, {}
    wd = {name: _harness_workdir(name) for name in HARNESS_KEYS}
    for name, tool, argv in (
            ("ema", ema_quality, ("--models", "unet", "--decays",
                                  HARNESS_EMA_DECAY, "--epochs", "2")),
            ("vgg", vgg_quality, ("--epochs", "2")),
            ("edsr", edsr_convergence, ("--epochs", "4", "--patience",
                                        "2"))):
        reports[name], seconds[name], counts, _ = _counted_run(
            lambda: _tool_main(tool, wd[name], *argv), totals)
        rows = reports[name].get("rows", reports[name])
        log("harness_run", tool=name, argv=list(argv), seconds=seconds[name],
            launches=counts, rows={k: {m: r[m] for m in ("ssim", "psnr")}
                                   for k, r in rows.items() if "ssim" in r})
    ema_rows, edsr = reports["ema"]["rows"], reports["edsr"]
    tag = f"ema{float(HARNESS_EMA_DECAY)}"
    raw = ckpt.load_checkpoint(str(wd["ema"] / f"ckpt_{tag}" /
                                   "rawfinal_model_unet.ckpt"))[0]
    control = ckpt.load_checkpoint(str(wd["ema"] / "ckpt_control" /
                                       "final_model_unet.ckpt"))[0]
    on_disk = {
        "ema": json.load(open(wd["ema"] / "ema_quality.json")),
        "vgg": json.load(open(wd["vgg"] / "vgg_quality.json")),
        "edsr": json.load(open(wd["edsr"] / "edsr_convergence.json"))}
    gates = {
        "keys": all(list(on_disk[k]) == v for k, v in HARNESS_KEYS.items()),
        "ema_rows": sorted(ema_rows) == sorted(
            f"unet/{r}" for r in ("best_control", f"best_{tag}",
                                  f"final_{tag}", f"finalraw_{tag}")),
        "finite": _finite_rows(ema_rows) and _finite_rows(reports["vgg"])
        and _finite_rows({k: v for k, v in edsr.items() if k != "protocol"}),
        "finalraw_is_control": _params_sha(raw) == _params_sha(control),
        "patience": edsr["protocol"]["patience"] == 2 and (
            wd["edsr"] / "ckpt" / "best_model_edsr.ckpt").exists(),
        "kernels": all(totals[k] > 0 for k in (
            "group_norm_leaky", "group_norm_leaky_backward", "conv3x3",
            "ssim_per_sample"))}

    # fetch_vgg_weights --pth, and the features of what it wrote
    pth, npz = HARNESS_DIR / "vgg19.pth", HARNESS_DIR / "vgg19.npz"
    sd = _vgg19_state_dict(18)
    torch.save(sd, pth)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = fetch_vgg_weights.main(["--pth", str(pth), "--out", str(npz)])
    x = torch.from_numpy(np.random.default_rng(18).random(
        (2, EXTRACT_TARGET, EXTRACT_TARGET, 1)).astype(np.float32)).to(dev)
    got = vgg_mod.VGG19Features.from_params(vgg_mod.load_params_npz(
        str(npz))).to(dev)(x)
    want = vgg_mod.VGG19Features.from_params(
        vgg_mod.params_from_torch_state_dict(
            {k: v.numpy() for k, v in sd.items()})).to(dev)(x)
    vgg_ok, vgg_err = within(got, want, 1e-5, 1e-5 * float(want.abs().max()))
    gates["fetch_vgg_weights"] = rc == 0 and vgg_ok
    ok = all(gates.values())
    seconds["phase"] = time.perf_counter() - start
    log("harness_path", roots={k: str(v) for k, v in roots.items()},
        pairs=str(EXTRACT_DIR), gates=gates, seconds=seconds,
        fetch_vgg_features={"shape": list(got.shape), "max_abs_err": vgg_err,
                            "bit_equal": bool(torch.equal(got, want))},
        launches=totals, ok=ok)
    if not ok:
        raise AssertionError(f"harness phase gates: {gates}")
    return {"launches": totals, "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on one "
                                 "NVIDIA GPU")
    ap.add_argument("--parent", default=None,
                    help="checkout of an older commit whose B2 kernel is "
                         "timed beside this one (earlier_ms)")
    args = ap.parse_args(argv)
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    # fp32 comparisons on the card in full fp32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = _build.build()
    lines = (_build.BUILD_DIR / "build.log").read_text().splitlines()
    regs = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    # kernels whose registers spill: ptxas names the function, then reports
    spills, func = [], None
    for ln in lines:
        if "Function properties for" in ln:
            func = ln.split("Function properties for")[-1].strip()
        elif re.search(r"[1-9]\d* bytes spill stores", ln):
            spills.append(f"{func}: {ln.strip()}")
    log("build", seconds=time.perf_counter() - t0, library=str(lib),
        ptxas=regs[:24], spills=spills)

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"B1": check_b1(dev, gen), "B3": check_b3(dev, gen),
               "B2": check_b2(dev, gen, args.parent),
               "B4": check_b4(dev, gen),
               "B4 fused": check_fused(dev, gen),
               "B1 backward": check_b1_backward(dev, gen)}
    # the remat leg's larger crop: B1's backward at its 20 sites
    check_b1_backward_sites(dev, gen, BATCH, LR, "remat leg's larger crop")
    c64 = check_b1_c64(dev, gen)
    cfg = ModelConfig(base_filters=BASE_FILTERS)
    params = build_model(cfg, generator=torch.Generator().manual_seed(0)
                         ).state_dict()
    lr = phantom_batch(np.random.default_rng(0), BATCH, LR)
    hr = phantom_batch(np.random.default_rng(0), BATCH, 2 * LR)
    counts, bf16_engine = main_path(dev, cfg, params, lr, hr)
    counts_volume = volume_path(dev, cfg, params)
    counts_int8 = int8_path(dev, cfg, params, lr, hr, bf16_engine)
    probe, counts_probe = probe_path(dev)
    trained = train_path(dev, lr)
    remat_profile_path(dev, trained)
    dp = dp_phase_path(dev, cfg, params, lr, hr, trained)
    spatial_bg = spatial_start(cfg, params)
    # QAT trains on the training phase's pairs and fine-tunes its
    # checkpoint; the daemon serves the QAT checkpoint
    qat = qat_path(dev, lr, hr)
    served = serve_path(dev, cfg, params, qat["final"])
    art = artifact_path(dev, lr, hr, qat["final"], trained["digests"])
    zoo = zoo_path(dev, lr, hr, c64)
    extract = extract_path(dev)
    evaluated = eval_path(dev, smi, extract["roots"])
    perc = perceptual_path(dev)
    spatial = spatial_path(dev, cfg, params, spatial_bg, smi)
    spatial_train = spatial_train_path(dev, smi)
    ema = ema_path(dev, lr, hr, trained)
    soak = soak_path(dev)
    harness = harness_path(dev, extract["roots"])

    torch_root = "mri_superresolution_torch/csrc/"
    tpu_root = "mri_superresolution_tpu/experiments/"
    meta = {
        "B1": ("group_norm_leaky", torch_root + "groupnorm_onepass.cu",
               tpu_root + "groupnorm_pallas.py:167", counts),
        "B2": ("ssim_per_sample", torch_root + "ssim_fused.cu",
               tpu_root + "ssim_pallas.py:75", counts),
        "B3": ("conv3x3", torch_root + "conv3x3_mma.cu",
               tpu_root + "conv_pallas.py:107", counts),
        "B4": ("leaky_quantize", torch_root + "leaky_quantize.cu",
               "tools/bench_int8_probe4.py:57", counts_int8),
        "B4 fused": ("gn_quantize", torch_root + "groupnorm_onepass.cu",
                     "tools/bench_int8_probe4.py:57", counts_int8),
        "B1 backward": ("group_norm_leaky_backward",
                        torch_root + "groupnorm_bwd_onepass.cu",
                        tpu_root + "groupnorm_pallas.py:273",
                        trained["counts"]),
    }
    rows = []
    for key in ("B1", "B2", "B3", "B4", "B4 fused", "B1 backward"):
        name, source, replaces, launches = meta[key]
        r = results[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
        for extra in ("earlier_ms", "sites", "all_20_sites", "shape",
                      "batch16", "device_kernels_a_call"):
            if extra in r:
                rows[-1][extra] = r[extra]
        # the zoo phase (unet_tpu, edsr, simple: training, volumes, one
        # forward in each precision) and the perceptual training run
        rows[-1]["zoo_launches"] = zoo["launches"][name]
        rows[-1]["perceptual_launches"] = perc["launches"][name]
        rows[-1]["extract_launches"] = extract["launches"][name]
        rows[-1]["eval_launches"] = evaluated["launches"][name]
        rows[-1]["qat_launches"] = qat["launches"][name]
        rows[-1]["serve_launches"] = served["launches"][name]
        rows[-1]["artifact_launches"] = art["launches"][name]
        rows[-1]["dp_launches"] = dp["launches"].get(name, 0)
        rows[-1]["phase_launches"] = dp["phase_launches"].get(name, 0)
        rows[-1]["spatial_launches"] = spatial["launches"].get(name, 0)
        rows[-1]["spatial_train_launches"] = spatial_train["launches"].get(
            name, 0)
        for col, phase in (("ema", ema), ("soak", soak),
                           ("harness", harness)):
            rows[-1][f"{col}_launches"] = phase["launches"].get(name, 0)
        if key in ("B1", "B1 backward"):
            rows[-1]["c64"] = c64["forward" if key == "B1" else "backward"]
        if key == "B2":
            one = r["one_image"]
            rows.append({**rows[-1], **{k: one[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "shape")}})
            rows[-1].pop("batch16")
            rows[-1].pop("earlier_ms", None)
            if "earlier_ms" in one:
                rows[-1]["earlier_ms"] = one["earlier_ms"]
        if key == "B1 backward":
            rows[-1]["onepass_launches"] = \
                trained["backward_onepass_launches"]
        if key in ("B1", "B3"):
            # the volume CLI's default run (3 batches of 32 slices)
            rows[-1]["volume_launches"] = counts_volume[name]
    for name, wrapper in (("copy", "roll_copy"), ("roll32", "roll32"),
                          ("taps3", "taps3")):
        r = probe[name]
        rows.append({"name": wrapper, "route": "cuda",
                     "source": torch_root + "roll_probe.cu",
                     "replaces": "tools/bench_roll_probe.py:98",
                     "launches": counts_probe[wrapper], "max_abs_err": 0.0,
                     "ms": r["us"] / 1e3, "plain_ms": r["plain_us"] / 1e3,
                     "bound_ms": probe_bound_ms(), "bound_by": "bytes",
                     "library_ms": None if r["library_us"] is None
                     else r["library_us"] / 1e3,
                     "extract_launches": extract["launches"][wrapper],
                     "eval_launches": evaluated["launches"][wrapper],
                     "qat_launches": qat["launches"][wrapper],
                     "serve_launches": served["launches"][wrapper],
                     "artifact_launches": art["launches"][wrapper],
                     "dp_launches": dp["launches"].get(wrapper, 0),
                     "phase_launches": dp["phase_launches"].get(wrapper,
                                                                0),
                     "spatial_launches": spatial["launches"].get(wrapper,
                                                                 0),
                     "spatial_train_launches": spatial_train[
                         "launches"].get(wrapper, 0),
                     **{f"{col}_launches": phase["launches"].get(wrapper, 0)
                        for col, phase in (("ema", ema), ("soak", soak),
                                           ("harness", harness))}})
    below = [r["name"] for r in rows if r["ms"] < r["bound_ms"]]
    if below:
        raise AssertionError(f"kernel times below their bound: {below}")
    log("wall", seconds=time.perf_counter() - start)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
