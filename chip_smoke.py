#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distkeras_tpu_torch``) once on one card.

    python3 chip_smoke.py

Phases, one JSON line each:

1. ``env``    — torch/CUDA versions, the card, TF32 switched off.
2. ``build``  — the flash kernels, ``distkeras_tpu_torch/ops/csrc/
   flash_fwd.cu`` (K1's C interface; K1 in f32 on CUDA cores: up to head
   dim 128 at grids too small for 64-row tiles, and past 256),
   ``flash_fwd_tf32_sm90.cu`` (K1 in f32 as 3xTF32 on mma.sync, up to
   head dim 256),
   ``flash_fwd_sm90.cu`` (K1 in bf16 up to head dim 256, on wgmma and
   TMA), ``flash_fwd_panels_sm90.cu`` (K1 in bf16 past 256, on wgmma
   and TMA in 256-column output panels), ``flash_bwd.cu`` (the
   backward's C interface),
   ``flash_bwd_tf32_sm90.cu`` (K2, K3 in f32 up to 256, as 3xTF32 on
   mma.sync), ``flash_bwd_tf32_panels_sm90.cu`` (K2, K3 in f32 past 256,
   as 3xTF32 in 512-column output panels), ``flash_bwd_sm90.cu`` (K2, K3
   in bf16 up to 256, on wgmma and TMA) and ``flash_bwd_panels_sm90.cu``
   (K2, K3 in bf16 past 256, on wgmma and TMA in 256-column output
   panels; the ``_sm90`` files include ``sm90.cuh``, the ``_tf32_`` ones
   ``tf32.cuh``), are built
   with nvcc for sm_90a if stale (seconds;
   each kernel's registers, shared memory and spills as ptxas reports
   them, and whether its wgmma products were serialized).
3. ``k1``     — the flash-attention forward kernel against its plain
   PyTorch version on the card: f32 at the serving shapes and a few
   others, Dh 128 among them (max abs error of O and lse <= 1e-5); bf16
   at T in {64, 100, 257, 512}, Dh 32, 64 and 128, causal and not,
   Tq != Tk (100 x 257, 512 x 100, 16 x 48) and a batch-1 join through
   ``flash_attention_lse`` (O and lse within rtol 1e-2 plus 1e-2 of the
   largest |value|, as ``GRAD_TOL``); both dtypes at the two training
   shapes (B*H = 512, Dh 64 and B*H = 256, Dh 128; T = 512, causal).
   The f32 serving shapes (the probe's at Dh 64, the dim-2048 model's
   joins at Dh 256) and the training shapes are timed: device
   time from a ``torch.profiler``
   trace, the plain version's, ``F.scaled_dot_product_attention``'s (a
   yardstick only: the port never calls it) and the least time the card
   could take (``bound_ms``).
4. ``slice``  — the ``scripts/mfu.py`` transformer probe
   (``gpt_lm(vocab 4000, dim 512, 8 heads, 4 blocks, seq_len 512,
   flash)``, random weights from seed 0, f32) served by
   ``DecodeEngine(ServeConfig(slots=4, max_new_tokens=64))`` after
   ``warmup()``: 8 greedy requests, some joining mid-decode.  Checks:
   (a) every answer equals the port's ``generate_tokens`` on the card
   (a mismatch is allowed only where the reference's top-2 logit gap is
   < 1e-4), (b) first-token logits of the flash model and of a dense
   model with the same weights agree within 1e-4, (c) the kernel's launch
   count over the served traffic is exactly 4 (one per attention block)
   per cold join, (d) ``jit.retraces == 0`` after warmup.
5. ``profile`` — the same traffic under a ``torch.profiler`` trace: the
   card's busy share and the top kernels.
   Then the serving plane on that model (f32, full width):
   ``fleet`` — 2 ``ServeServer``s over prefix-cached engines (4 slots,
   ``prefix_block`` 16, 512 MB) behind a ``ServeRouter`` with the KV
   fabric (``affinity_block`` 16, ``max_inflight`` 4), driven by
   ``ServeClient``s over loopback (``FLEET``): a serialized cold pass of
   4 prompt groups (a 256-token shared prefix, 16-token tails, 16 new
   tokens), 3 warm requests a group at once (twice, the second under the
   profiler for the busy share), a forced spill a group (the owner pinned
   at ``max_inflight``: it lands cold, seeds a replication, and a second
   spill lands warm on the replica), a planned drain of one engine (its
   hot KV migrates; a follow-up a group lands warm), a fleet promote
   while it is out (it is scaled up and rolled forward; a ``kv_push``
   stamped with the old version is refused) and 8 sampled requests
   (temperature 0.8, top-k 50) that each end at 16 tokens.  Checks:
   greedy answers equal ``generate_tokens``, the router's requests ==
   completed + rejected + timeouts with none rejected, prefix misses and
   hits as the passes dictate, replications, no stale join, and K1
   launched exactly 4 x the engines' cold joins (``serve.prefix.misses``)
   — none in a warm join or a decode step.  Printed: TTFT p50 cold,
   warm, spill-cold and spill-warm, the warm pass's tokens/s, the
   fabric's bytes, the busy share.  ``fleet_racecheck`` runs it all again
   under the port's race checker, which must record no violation (a
   ``racecheck`` row: both runs' seconds).  ``spec`` — 8 greedy requests of
   32–96 tokens, 32 new tokens, through a plain engine and two
   ``spec_k=4`` engines: draft = the probe itself (accept rate 1.0) and
   ``gpt_lm(dim 128, 2 heads, 2 blocks)`` (accepts below 1); answers equal
   ``generate_tokens``, K1 (target + draft blocks) x joins; K1 checked
   at the draft's join shapes.  ``beam`` — ``generate_beam`` over 2
   prompts of 64 tokens, 4 beams, 16 steps, against the dense twin:
   equal tokens, scores within 1e-4, K1 once per block (checked at the
   prefill's shape, B·H 64).
6. ``k2k3``   — the backward kernels K2 (dQ) and K3 (dK, dV) against
   their plain version (``flash_bwd_plain``, which rounds P and dS to
   bf16 for bf16 inputs as the reference does) on the card: f32 and
   bf16, causal and not, T in {64, 100, 256, 257, 512} (once with
   Tq != Tk), Dh 32, 64 and 128, the training shape (bf16 also at
   Dh 32) and its Dh-128 twin (B*H = 256), and f32 rows of 2048 and 4096
   at Dh 64 and 128: f32 within the JAX package's flash-vs-dense
   gradient bound (rtol 5e-4, atol 1e-5), bf16 within the bf16 rounding
   (rtol 1e-2, atol 1e-2 of the largest |value|).  Then, at the training
   shape (B*H = 512, T = 512, Dh = 64, causal) and at B*H = 256, Dh = 128
   (bf16 and f32 each), each kernel checked so against the plain version
   first, then its profiler device time and achieved
   TFLOP/s, the plain version's time, the device time of
   ``F.scaled_dot_product_attention``'s backward (one call for K2 and K3
   together; a yardstick only) and ``bound_ms``.
7. ``train``  — the same probe model trained by ``SingleTrainer``:
   (a) f32, flash and dense twins from seed 0, 2 epochs of 4 SGD steps
   of batch 16, run flash, dense, dense, flash: per-step losses within
   rtol 1e-4 and every trained parameter within atol 1e-4, K1, K2 and K3
   launched exactly 4 x 8 times each in every flash run, and each run's
   step ms from its warm (second) epoch; (b) the
   probe's training config, reduced only in batch (batch 64 for
   ``mfu.py``'s 1024; sgd, lr 0.1, bf16 compute), 3 epochs of 8 steps:
   losses finite and falling, ``jit.retraces == 0``, K1, K2 and K3
   launched exactly 4 x 24 times each; its samples/s, tokens/s, step ms
   and peak memory; then two more epochs under a ``torch.profiler``
   trace, of which the second gives the busy share (device time over
   the epoch's span on the device's timeline) and each kernel's share.
8. ``lm128``  — ``scripts/mfu.py``'s ``--dim 1024`` probe (8 heads of
   Dh 128), bf16, 2 epochs of 8 steps at batch 32: the loss falls and
   K1, K2 and K3 launch exactly once per block per step.  ``lm256`` —
   the ``--dim 2048`` probe (8 heads of Dh 256; in bf16 K1, K2 and K3 on
   wgmma; in f32 all three as 3xTF32 on mma.sync): bf16, 2 epochs
   of 4 steps at batch 16, the loss falls; 2
   f32 steps against its dense twin (losses within rtol 1e-4, parameters
   within 1e-4); 4 greedy requests served, each equal to
   ``generate_tokens``; K1, K2 and K3 once per block per step, K1 once
   per block per join; each launch counted under the kernel of that
   route, none under a CUDA-core kernel in training.  ``lm96`` —
   ``gpt_lm`` at dim 768 (8 heads of Dh 96, GPT-NeoX-20B's and
   Phi-3-mini's head dim, which the bf16 kernels read unpadded into
   128-wide tiles): bf16, 2 epochs of 8 steps at batch 32, the loss
   falls and K1, K2 and K3 launch exactly once per block per step, each
   counted at Dh 96 under its wgmma kernel; a profiled warm step whose
   flash kernels are all wgmma ones, in a run where no operator pads or
   touches a tensor of the old padded (B*H, T, 128) shape; 2 f32 steps
   against the dense twin (losses within rtol 1e-4, parameters within
   1e-4).
9. ``conv``   — the headline bench's ResNet-20 (``distkeras_tpu_torch.
   bench``: width 16, batch 1024, sgd lr 0.1, bf16), 3 epochs of 8
   steps: samples/s, step ms, peak memory, and the busy share of a
   profiled warm two-epoch run; the loss falls and every BatchNorm
   state leaf is finite and has moved.  Then an f32 ResNet-20 on the
   card (TF32 off, cuDNN deterministic) against the port on the CPU
   from the same seed's weights, at the bench's lr 0.1: the eval forward
   and the losses of 2 SGD steps within atol 1e-4, and each parameter
   and state leaf's 2-step change within ``F32_STEP_REL`` of the CPU's
   (relative, in norm).  A control run on the card with TF32 on must
   fail that check; a float64 run on the CPU (the witness) gives both
   f32 runs' distance from the exact step.
10. ``mnist`` and ``models`` — the MNIST time-to-99% row (the bench's
   ``--mnist``), and one bf16 training step each of ``lstm_imdb``,
   ``resnet50(stem="conv7")`` and ``resnet50(stem="s2d")`` at full width
   and a small batch, with finite losses.
11. ``dist``  — the sync distributed trainers at 8 workers on the card
   (``DIST_CONFIGS``, the yaml's configs, run as ``DIST_RUNS`` with the
   epochs of ``DIST_EPOCHS``): ADAG ConvNet, DOWNPOUR ResNet-20, AEASGD
   and EAMSGD LSTM, DynSGD ResNet-50, AveragingTrainer and
   EnsembleTrainer MLP; per run samples/s, ms a window, ms of the window
   edge alone (CUDA events), peak memory and the epochs' mean losses.
   Checks: every loss is finite and falls (DynSGD's, which rises over its
   3 epochs, excepted: its first 2 windows are held instead to a float64
   twin of the same windows on the card within ``F64_LOSS_TOL`` and
   ``F64_CENTER_REL``, and a control with one center leaf moved must fail
   that check), and after one more window the edge obeys its
   rule on the stacked tensors, computed in float64 (each worker model's
   parameters views into the stack).  Then ADAG over the probe LM in bf16
   (8 workers of batch 8, window 2): K1, K2 and K3 launched exactly
   workers x steps x blocks times, and held at its shape (B*H 64).  Then
   ``dist_parity``: f32 ADAG on the toy problem of tests/
   test_trainers_sync.py (8 workers, window 4) on the card against the
   CPU within rtol 1e-5 plus 1e-6 of the largest |value|; and DOWNPOUR
   over ResNet-20 (width 16, 2 windows of 2 steps at batch 8) against
   the CPU by ``f32_parity_ok``, with a TF32-on control that must fail.

12. ``config`` — configs/bench_all.yaml through the port's config layer
   (``phase_config``): its flash LM (``YAML_LM``: dim 128, 4 heads of Dh
   32, bf16, 4 epochs of 32 steps at batch 64) as configured, by
   ``config.run(cfg, repeat=2)``, then its ``quick`` variant (Dh 16,
   read unpadded into 32-wide tiles by the bf16 kernels): K1, K2 and K3
   launched exactly
   once per block per step, the loss falls, the rows printed as
   ``config.main`` prints them; ``config.main([file, "--quick"])`` over
   every config of the file (the stream-from-disk ones spilled and
   streamed); the flash LM as a ``Job`` run by ``job_runner`` in a child
   process on the card, its launches folded into the parent's and
   checked, its parameters bit-identical to the in-process run's
   (``JOB_PARAM_TOL``).
13. ``ckpt`` — the bf16 probe LM (``train``'s part (b)) trained 3 epochs
   straight (twice: the run repeats bit for bit) and 1 epoch with
   ``checkpoint_dir`` then resumed to 3: parameters and the resumed
   epochs' losses bit-identical to the straight run's, K1-K3 counted on
   both; the checkpoint's bytes and its save and load ms; then
   ``serialize()`` -> ``deserialize_model`` -> ``load_jax_variables``
   onto the card, 4 greedy requests served through ``DecodeEngine``
   equal to the trained model's ``generate_tokens``; then ADAG on the
   ConvNet at 8 workers, 2 epochs straight against 1 plus a resume, the
   center bit-identical.
14. ``stream`` — configs/bench_all.yaml's two stream-from-disk configs
   (``STREAM_CONFIGS``: ResNet-50/96px, bf16, ``SingleTrainer`` from
   256-row shards, ADAG at 8 workers from 128-row shards; the yaml's 4
   and 3 epochs cut to ``STREAM_EPOCHS``, 2), from shards written to a temporary directory: samples/s of
   the last epoch, stall seconds, the prefetch queue's mean depth over
   the run, peak memory and the busy share of its last epoch, each
   config run once, under the profiler; the loss falls.  One epoch of the SingleTrainer
   config from RAM and from disk: parameters within rtol 2e-5, atol
   2e-6.
15. ``async`` — the asynchronous parameter server (on the host, over
   loopback TCP) with ``mode="async"``: ``DOWNPOUR``, ``ADAG``,
   ``DynSGD``, ``AEASGD`` and ``EAMSGD`` on the probe LM (full width,
   bf16) with 4 thread workers of batch 8, each at its default window
   for 2 windows (``ASYNC_RULES``); DOWNPOUR again under each wire
   option (``ASYNC_WIRE``: the int8, bf16 and top-k 1% commit codecs,
   int8 DOWN pulls, the shared-memory ring sized to the center,
   dispatch-ahead pulls); ADAG ConvNet/CIFAR-10 at ``DIST_WORKERS``
   async workers beside the sync ``dist`` figure; 2 process workers on
   the yaml's flash LM; a commit reset (``SocketFaults``), a stalled
   worker evicted and respawned (``ThreadStall``), an ``add_worker``
   join, and a PS checkpoint then an exact resume.  Per run: samples/s,
   commits a worker, commit and pull round trips p50/p99, bytes per
   commit and pull, codec bytes, DynSGD's staleness p50/p99, the first
   and last window's mean loss, the PS's accounting (``requests ==
   applied + dropped + tombstoned`` checked) and K1–K3 launches, checked
   exactly (workers x windows x steps x blocks; a worker process's
   launches folded into the parent's).  Each run is a path of the
   ``kernels`` line (``async_downpour``, ..., ``async_processes``).
   The wire phase's plain DOWNPOUR run runs again right after it under
   the port's race checker (``async_racecheck``,
   ``distkeras_tpu_torch.analysis.racecheck``), which must record no
   violation; a ``racecheck`` row puts the two runs' seconds side by
   side.
16. ``continual`` — ``ContinualTrainer`` over the bf16 probe with the JAX
   bench's cadence and a drift at interval 10, a live f32 engine as its
   deploy target (``phase_continual``): exact K1–K3 launches on
   training and serving, deploys equal to their checkpoints and served
   as ``generate_tokens`` of them, the drift rejected as dirty, a crash
   restarted at its batch offset, an f32 twin against the CPU.
17. ``scenario`` — ``smoke``, ``diurnal`` (its period cut to 2 s) and
   ``chaos`` (cut to 4 s; ``SCENARIO_TRACE_CUTS``) fired open-loop at a router
   fleet of the f32 probe under ``OBS_BASELINE.json``'s alert rules and
   the autoscaler (``phase_scenario``).
18. ``obs`` — the bf16 probe trained with ``profile={"trace_dir",
   "step_split"}``: the trace names K1–K3, the step split, the Chrome
   export and the Prometheus text (``phase_obs``).
19. ``mesh`` — two ranks sharing the card over gloo (``phase_mesh``),
   spawned once (``chip_smoke.py --mesh-rank``): ring, zigzag and
   Ulysses attention of the probe at seq_len 2048 on an ``sp`` mesh of 2
   (forward, gradients, f32 and bf16 ``SingleTrainer`` steps; K1–K3 per
   rank exactly the schedule's), ADAG and DOWNPOUR at 4 workers over the
   2 ranks, ResNet-20 with ``BatchNorm(axis_name="workers")``, the MoE
   probe on an ``ep`` mesh of 2 and DOWNPOUR's async cluster, each held
   against a one-process oracle on the card; the backend and why, each
   collective's route and the bytes through the host, step ms a rank
   beside the oracle's.  Then the probe trained by ``SpmdTrainer`` on
   dp × mp (``mesh_spmd``: mp 2 in f32 and bf16, dp 2 in f32; every
   parameter block, optimizer state and gradient on the card, the split
   leaves' per-device bytes under their global bytes, K1–K3 launches a
   rank equal to the oracle's) and by ``PipelineTrainer`` on pp 2
   (``mesh_pipe``, M 4: each rank half the stack, K1–K3 exactly (M + S
   − 1) × 2 a step), both against a one-process ``SingleTrainer``
   oracle; ``zigzag_wrap`` of the ring LM (``mesh_zigzag``) against the
   unwrapped zigzag ring, the stripe paid once a batch; and, on rank 0,
   ``fold_batchnorm`` of a ResNet-20 against its unfolded eval forward.

``k1`` and ``k2k3`` also hold head dims 16, 48, 80 and 96 (which bf16
K1, K2 and K3 read unpadded into 32-, 64- and 128-wide tiles, the f32 K1
reads unpadded and the f32 K2 and K3 run zero-padded to 32, 64 and 128),
5 and 127 (bf16 zero-padded to 8 and 128, the TMA row stride's multiple;
the f32 K1 unpadded on both its kernels), 136,
192, 200 and 256 (bf16 K1, K2 and K3 on wgmma, f32 K1, K2 and K3 as
3xTF32 at every grid; f32 also at 130, 193 and 255, read by 4-byte
loads) and 320 (bf16 K1, K2 and K3 on wgmma and the f32 K1 on CUDA cores
in two 256-column panels, the f32 K2, K3 as 3xTF32 in one of 512; bf16
K1, K2 and K3 also at 264, 300 padded to 304, and 512; f32 K2, K3 also
at 261, read by 4-byte loads),
and time 16 and 96 beside 32 and 128 at B*H 256 and 192, 256, 320 and
512 at B*H 128 (T 512).  Where an f32 kernel's output reads an error of
exactly 0 against the plain version, ``k2k3`` also shows the check is
live: a copy with its smallest value moved by 1e-4 must fail it.
``k1_tf32_control``: on Q and K with a common offset, the f32 K1 on
tensor cores (at Dh 192 and 256 its eight-warp kernel) is within 1e-5
of attention in float64 and one TF32 pass is not;
``k2_tf32_control`` and ``k3_tf32_control`` hold the f32 K2 and K3 at
Dh 192, 256, 320 and 512 so (dQ, dK and dV against K2 and K3 in
float64, within ``GRAD_TOL``).
``past256``: K1, K2 and K3 at Dh 320 in both
dtypes through the differentiable op (``flash_attention_lse`` and
autograd) against the plain versions, one launch each of the kernel the
dtype routes to: the one path of the f32 K1 on CUDA cores past Dh 256,
of the f32 K2 and K3 in 3xTF32 panels there (``flash_bwd_dq_f32_past256``,
``flash_bwd_dkv_f32_past256``) and of the bf16 ones on wgmma
(``flash_fwd_wgmma_past256``, ``flash_bwd_dq_wgmma_past256``,
``flash_bwd_dkv_wgmma_past256``), counted as the other paths are.

Then the ``kernels`` line (one entry per CUDA kernel: its launches on
the main paths, counted by the wrappers under the kernel each C entry
point reports it ran; its largest error against the plain version over
the checked cases it ran, every timed shape among them; its timed
rows), the card's name and power limit as nvidia-smi prints them,
and as the last line ``{"ok": true, "device": {...}}``.  A
``torch.profiler`` trace that holds no device event is taken again a
second later, three times at most; a time then comes from CUDA events
and a busy share is null (not measured), each listed in the ``timing``
line's ``profiler_gaps``.  Any
failed check exits non-zero before that line; so does a machine without
CUDA, and a directory holding this script without the package.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 on the tensor
#: cores, and HBM3 bandwidth.  An exact f32 product costs three TF32
#: products (3xTF32), so the least time for f32 work is its operations at
#: a third of the TF32 rate, above the 67 TFLOP/s of f32 outside the
#: tensor cores.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES = 3.35e12

#: K2/K3 against flash_bwd_plain on the same inputs: f32 within the JAX
#: package's flash-vs-dense gradient bound (tests/test_pallas_attention.py:
#: 41); bf16, where both sides round P, dS and their outputs to bf16,
#: within that rounding: rtol 1e-2 plus 1e-2 of the reference's largest
#: |value| (``atol_of_max``)
GRAD_TOL = {"float32": dict(rtol=5e-4, atol=1e-5, atol_of_max=0.0),
            "bfloat16": dict(rtol=1e-2, atol=0.0, atol_of_max=1e-2)}
#: the training shape of the probe: batch 64 x 8 heads, T = 512, Dh = 64
TRAIN_BH, TRAIN_T, TRAIN_DH = 64 * 8, 512, 64
#: a head-dim-128 training shape: gpt_lm(dim=1024, num_heads=8) at batch
#: 32 (B*H = 256), T = 512
DH128_BH = 256
HEAD_DIMS = (32, 64, 128)
#: head dims between the tile widths: bf16 K1, K2 and K3 read them
#: unpadded into 32-, 64- and 128-wide tiles (the columns past Dh
#: zero-filled by TMA), the f32 K1 reads them unpadded, and the f32 K2 and
#: K3 run them zero-padded to the next of HEAD_DIMS
BETWEEN_HEAD_DIMS = (16, 48, 80, 96)
#: head dims not a multiple of 8, which the bf16 kernels run zero-padded
#: to the next multiple of 8 (their TMA row stride)
ODD_HEAD_DIMS = (5, 127)
#: head dims past 128: bf16 K1, K2 and K3 on wgmma (192- and 256-wide
#: tiles), f32 K1, K2 and K3 as 3xTF32 (192- and 256-wide tiles)
WIDE_HEAD_DIMS = (136, 192, 200, 256)
#: head dims past 128 that are not a multiple of 4: the f32 kernels read
#: their rows unpadded by 4-byte loads
WIDE_ODD_HEAD_DIMS = (130, 193, 255)
#: head dims past 256, in output panels: f32 K1 on CUDA cores and bf16 K1,
#: K2 and K3 on wgmma (256 columns), f32 K2 and K3 as 3xTF32 (512
#: columns); checked at 320, timed at 320 and 512 (B*H 128)
PAST_HEAD_DIM = 320
#: an f32 head dim past 256 that is not a multiple of 4: the f32 K2 and
#: K3 read its rows by 4-byte loads, into a last 128-column chunk of 5
PAST_F32_ODD_HEAD_DIM = 261
#: more bf16 head dims past 256 for K1, K2 and K3 on wgmma: 264 (a last
#: panel of 8 columns), 300 (padded to 304) and 512 (two full panels)
PAST_BF16_HEAD_DIMS = (264, 300, 512)
PAST_TIMED_HEAD_DIMS = (320, 512)
#: a head-dim-256 training shape: gpt_lm(dim=2048, num_heads=8) at batch
#: 16 (B*H = 128), T = 512
DH256_BH = 128
#: the headline bench's ResNet-20 (distkeras_tpu_torch/bench.py), cut to
#: 3 epochs of 8 steps
CONV = dict(steps=8, epochs=3)
#: the f32 ResNet-20 check (``f32_parity_ok``): the largest relative error
#: of a leaf's 2-step change, card against CPU.  On an H100 (700 W) the
#: card read 0.0074 and the TF32 control 0.38; each f32 run is 0.038-0.039
#: from the float64 witness (its batch statistics, E[x²] − E[x]² summed in
#: f32, round alike on both), so the limit sits between the two readings
F32_STEP_REL = 0.05
SCE = "sparse_categorical_crossentropy"
LM = dict(vocab_size=4000, dim=512, num_heads=8, num_blocks=4, seq_len=512,
          attention_impl="flash")
#: scripts/mfu.py's --dim 1024 probe: 8 heads of Dh = 128
LM128 = dict(LM, dim=1024)
#: scripts/mfu.py's --dim 2048 probe: 8 heads of Dh = 256
LM256 = dict(LM, dim=2048)
#: scripts/mfu.py's probe at dim 768: 8 heads of Dh = 96, the head dim of
#: GPT-NeoX-20B and Phi-3-mini, which the bf16 kernels read unpadded into
#: 128-wide tiles
LM96 = dict(LM, dim=768)
#: configs/bench_all.yaml, which the runs below read through the port's
#: config layer (``distkeras_tpu_torch.config.load_file``, the port's own
#: YAML reader: the card's machine has no yaml)
BENCH_YAML = os.path.join(ROOT, "configs", "bench_all.yaml")


def yaml_configs(*names):
    """The named configs of ``BENCH_YAML``, each as a dict of its
    ``RunConfig`` fields.  Unset keys take the file's defaults
    (``config.py``'s ``_DEFAULT_TRAINER_KW``: loss
    categorical_crossentropy, features "features", labels
    "label_onehot")."""
    import dataclasses
    from distkeras_tpu_torch.config import load_file
    cfgs = {c.name: dataclasses.asdict(c) for c in load_file(BENCH_YAML)}
    return {n: cfgs[n] for n in names}


#: the sync distributed configs and the SingleTrainer MLP/MNIST config
#: that AveragingTrainer and EnsembleTrainer run
DIST_CONFIGS = yaml_configs(
    "SingleTrainer MLP/MNIST", "ADAG ConvNet/CIFAR-10 (auto-w)",
    "DOWNPOUR ResNet-20/CIFAR-10 (auto-w)", "AEASGD LSTM/IMDB (auto-w)",
    "DynSGD ResNet-50/96px (auto-w)")
#: ``num_workers: auto`` on one card: the cap distkeras_tpu/config.py:
#: 114-119 gives it, the reference examples' worker count
DIST_WORKERS = 8
#: the DOWNPOUR BatchNorm check's learning rate.  At the yaml's 0.01 the
#: f32 run itself is chaotic at batch 8 (the reference's BatchNorm sums
#: E[x²] − E[x]² in f32): the port's f32 run on the CPU lands 0.17 (per
#: leaf, in norm) from its float64 run, so no two f32 runs can be held
#: within F32_STEP_REL.  At 3e-4 the card read 0.016 from the CPU and its
#: TF32 control 0.24 (H100, 700 W)
DIST_BN_LR = 3e-4
#: the runs of the ``dist`` phase: (trainer class, config); the AEASGD
#: config also runs EAMSGD, the MLP/MNIST config the two averaging
#: trainers.  ``epochs`` cuts a config's num_epoch (PERF.md §4 lists it)
DIST_RUNS = (
    ("ADAG", "ADAG ConvNet/CIFAR-10 (auto-w)"),
    ("DOWNPOUR", "DOWNPOUR ResNet-20/CIFAR-10 (auto-w)"),
    ("AEASGD", "AEASGD LSTM/IMDB (auto-w)"),
    ("EAMSGD", "AEASGD LSTM/IMDB (auto-w)"),
    ("DynSGD", "DynSGD ResNet-50/96px (auto-w)"),
    ("AveragingTrainer", "SingleTrainer MLP/MNIST"),
    ("EnsembleTrainer", "SingleTrainer MLP/MNIST"),
)
#: the two LSTM runs (about 14 s an epoch on an H100: the LSTM steps
#: its 200 positions from Python) are cut from 3 epochs to 2
DIST_EPOCHS = {"AEASGD": 2, "EAMSGD": 2}
#: runs whose loss need not fall over the configured epochs.  DynSGD's
#: rises over its 3 (5.83, 6.26, 6.37 on an H100; the JAX package's own
#: DynSGD on the CPU at 32 px rises alike: 8 workers' deltas summed in full
#: at lr 0.005), and whether its tenth epoch is below its first depends on
#: cuDNN's nondeterministic backward (5.816 -> 5.865 and 5.840 -> 4.920 on
#: one tree).  It is held instead to a float64 twin of its first windows
#: (``_windows_f64_reading``)
NO_DIRECTION_CHECK = ("DynSGD",)
#: the float64-twin check of DynSGD's first ``F64_WINDOWS`` windows
#: (``_windows_f64_ok``): the per-step losses' largest abs error
#: (``F64_FIRST_LOSS_TOL`` for each worker's first step, whose weights are
#: the same initial ones in both runs), and ``center_rel``, the error of
#: the center's change Δ from the initial weights over all its leaves at
#: once, ||Δ32 − Δ64|| / ||Δ64||.  The f32 gradient of this BatchNorm
#: ResNet-50 at its initial weights is 2.3% from float64's (median over
#: leaves, one batch on the CPU), and the dynamics amplify it: on the CPU
#: the port read losses 0.24 apart by the fourth step and center_rel
#: 0.123 (cosine 0.992), each leaf's own change no closer than its size.
#: On an H100 (700 W) the card read 6.0e-5 on the first step, 0.333 over
#: all 4, and center_rel 0.121; the bounds sit at about twice that
F64_WINDOWS = 2
F64_FIRST_LOSS_TOL = 1e-3
F64_LOSS_TOL = 0.7
F64_CENTER_REL = 0.25
#: the yaml's flash LM (dim 128, 4 heads of Dh 32, bf16) — its ``quick``
#: variant has Dh 16, which the bf16 kernels read unpadded into 32-wide
#: tiles
YAML_LM = "GPT-LM flash T=256 (bf16)"
#: the two stream-from-disk configs: ``streaming`` is rows a shard,
#: spilled by ``ShardedFileDataset.write`` (``config.build``)
STREAM_CONFIGS = yaml_configs(
    "ResNet-50/96px stream-from-disk",
    "ADAG ResNet-50/96px stream-from-disk (auto-w)")
#: the stream-from-disk configs cut from the yaml's 4 and 3 epochs to 2
#: each, for the run's time limit (the loss still has two epochs to fall)
STREAM_EPOCHS = 2
PROMPT_LENS = (20, 64, 100, 128, 200, 256, 300, 448)
MAX_NEW = (64, 16, 40, 24, 64, 32, 48, 64)


class CheckFailed(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def kernel_launches():
    """The wrappers' launches since the last ``reset_launches``, by the
    kernel that ran: [kernel, dtype, head dim, launches] rows."""
    from distkeras_tpu_torch.ops.flash_attention import KERNEL_LAUNCHES
    return [[k, d, h, n] for (k, d, h), n in sorted(KERNEL_LAUNCHES.items())]


def launched(call):
    """``call()``'s result and the name of the one kernel it launched,
    read from the wrappers' launch counts."""
    from collections import Counter
    from distkeras_tpu_torch.ops.flash_attention import KERNEL_LAUNCHES
    before = Counter(KERNEL_LAUNCHES)
    out = call()
    ran = {k for k, _, _ in KERNEL_LAUNCHES - before}
    check(len(ran) == 1, f"expected one kernel launched, got {ran}")
    return out, ran.pop()


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


#: what the profiler did not deliver: a ``torch.profiler`` CUDA trace now
#: and then comes back without a single device event (seen once in a
#: dozen sessions of one process, and three times in a row in one ``k1``
#: phase).  One entry per such trace and per measurement that was then
#: taken otherwise or not at all; emitted with the phase times
PROFILER_GAPS = []
#: traces taken before a measurement falls back, and the seconds between
#: a trace that held no device event and the next
PROFILER_TRIES = 3
PROFILER_RETRY_S = 1.0


def _profiler_gap(what, outcome):
    PROFILER_GAPS.append({"what": what, "outcome": outcome})


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: the durations of the kernels (and
    copies) it ran, from a ``torch.profiler`` CUDA trace, summed — the
    card's time without the host's launch overhead.  A trace without
    device events is taken again a second later; after three of them in
    a row the calls are timed between two CUDA events instead (the
    host's launch gaps included), and ``PROFILER_GAPS`` says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    caller = sys._getframe(1)
    what = f"device_ms at {caller.f_code.co_name}:{caller.f_lineno}"
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages())
        if us > 0:
            return us / iters / 1e3
        _profiler_gap(what, "trace taken again")
        time.sleep(PROFILER_RETRY_S)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    _profiler_gap(what, f"timed with CUDA events: {ms} ms")
    return ms


def traced(torch, run, what, **kw):
    """``run()`` under a ``torch.profiler`` trace (CUDA only unless
    ``kw`` says otherwise): (its result, the trace).  ``run`` must be
    safe to call again: a trace that holds no device event is taken
    again, a second later, up to ``PROFILER_TRIES`` traces in all; after
    that the trace is None, and what it would have measured is not
    measured."""
    from torch.profiler import ProfilerActivity, profile
    kw.setdefault("activities", [ProfilerActivity.CUDA])
    for _ in range(PROFILER_TRIES):
        with profile(**kw) as prof:
            out = run()
            torch.cuda.synchronize()
        if device_events(prof):
            return out, prof
        _profiler_gap(what, "trace taken again")
        time.sleep(PROFILER_RETRY_S)
    _profiler_gap(what, "not measured")
    return out, None


def flash_bound(bh, tq, tk, dh, causal, itemsize):
    """(bound_ms, bound_by) for one forward: operations over the peak of
    the input type (f32 at the 3xTF32 rate), bytes (q/k/v read once, O
    and lse written once) over the memory rate — the larger of the
    two."""
    pairs = tq * (tq + 1) // 2 if causal else tq * tk
    flops = 4 * bh * dh * pairs
    nbytes = itemsize * bh * dh * (2 * tq + 2 * tk) + 4 * bh * tq
    peak = PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def flash_bwd_flops(kernel, bh, t, dh):
    """FLOPs of one causal K2 or K3 call: K2 recomputes S and forms dP and
    dQ, 6·Dh FLOPs per unmasked (q, k) pair; K3 forms S, dP, dV and dK,
    8·Dh."""
    return (6 if kernel == "dq" else 8) * dh * bh * (t * (t + 1) // 2)


def flash_bwd_bound(kernel, bh, t, dh, itemsize):
    """(bound_ms, bound_by) for one causal K2 or K3 call: its operations
    (``flash_bwd_flops``) over the peak of the input type (f32 at the
    3xTF32 rate), bytes (q, k, v, dO read once, L and D f32, the
    gradients written once) over the memory rate — the larger of the
    two."""
    flops = flash_bwd_flops(kernel, bh, t, dh)
    n_out = 1 if kernel == "dq" else 2
    nbytes = itemsize * bh * t * dh * (4 + n_out) + 2 * 4 * bh * t
    peak = PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_env(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    row = {"phase": "env", "python": sys.version.split()[0],
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi_line(),
           "allow_tf32": {"matmul": False, "cudnn": False}}
    emit(row)
    return row


def ptxas_report(log):
    """Per kernel, from ``nvcc -Xptxas -v``'s log: registers, shared
    memory (static bytes; the dynamic share is set at launch), spill
    bytes, and whether ptxas serialized its wgmma products (its C7514 and
    C7515 warnings: the overlap of products with other work is then
    lost)."""
    import re

    def short(mangled):
        # the kernel's name and template arguments, still mangled
        name = re.search(r"flash_(fwd|bwd_dq|bwd_dkv)"
                         r"(_wgmma|_tf32|_wide|_panels)*"
                         r"_kernel(I\w*?E(?=E))?", mangled)
        return name.group(0) if name else mangled

    rows, cur = [], None
    serialized = {short(m.group(1)) for m in re.finditer(
        r"wgmma\.mma_async instructions are serialized.*?function '(\w+)'",
        log)}
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = {"kernel": short(m.group(1))}
            cur["wgmma_serialized"] = cur["kernel"] in serialized
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int,
                                                              m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", ln)
                cur["smem_bytes"] = int(m.group(1)) if m else 0
    return rows


def phase_build():
    from distkeras_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    built = _kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built["built"], "ptxas": ptxas_report(built["log"])})


def phase_k1(torch):
    """K1 against its plain version; returns the per-case rows."""
    import torch.nn.functional as F
    from distkeras_tpu_torch.ops.flash_attention import (
        _to_bh, flash_attention_lse, flash_fwd_cuda, flash_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (dtype, causal, bh, tq, tk, dh, timed)
    cases = []
    for t in (64, 128, 256, 512):
        cases.append(("float32", True, 8, t, t, 64, True))
    for t in (64, 128, 256, 512):
        cases.append(("float32", False, 8, t, t, 64, False))
    cases += [("float32", False, 8, 16, 48, 64, False),
              ("float32", True, 8, 100, 100, 64, False),
              ("float32", True, 8, 256, 256, 32, False),
              ("float32", True, 8, 256, 256, 128, False),
              ("float32", False, 8, 100, 257, 128, False)]
    for t in (64, 100, 257, 512):
        for dh in HEAD_DIMS:
            for causal in (True, False):
                cases.append(("bfloat16", causal, 8, t, t, dh, False))
    for tq, tk in ((100, 257), (512, 100), (16, 48)):
        for dh in HEAD_DIMS:
            cases.append(("bfloat16", False, 8, tq, tk, dh, False))
    # head dims between the tile widths (bf16 and f32 unpadded), and bf16
    # at head dims not a multiple of 8 (zero-padded to one)
    cases += [(dtype, causal, 8, t, t, dh, False)
              for dtype in ("bfloat16", "float32")
              for dh in BETWEEN_HEAD_DIMS
              for causal in (True, False) for t in (100, 257)]
    cases += [(dtype, False, 8, 100, 257, dh, False)
              for dtype in ("bfloat16", "float32")
              for dh in BETWEEN_HEAD_DIMS]
    cases += [("bfloat16", causal, 8, t, t, dh, False)
              for dh in ODD_HEAD_DIMS for causal in (True, False)
              for t in (100, 257)]
    # the f32 K1 on tensor cores (B*H 136: 64-row tiles fill the card) at
    # head dims between 32, 64 and 128, and not a multiple of 4 (its 4-byte
    # loads); the same on CUDA cores (B*H 8)
    cases += [("float32", causal, bh, 130, 130, dh, False)
              for bh in (136, 8) for dh in (5, 48, 96, 127)
              for causal in (True, False)]
    # the f32 K1 at 129-256 on a grid that fills the card (B*H 136), Dh %
    # 4 != 0 among them, causal and not, Tq != Tk
    cases += [("float32", causal, 136, 130, 130, dh, False)
              for dh in (*WIDE_HEAD_DIMS, *WIDE_ODD_HEAD_DIMS)
              for causal in (True, False)]
    cases += [("float32", False, 136, 100, 257, dh, False)
              for dh in (192, *WIDE_ODD_HEAD_DIMS)]
    # head dims past 128 at B*H 8 (bf16 on wgmma, f32 as 3xTF32, up to
    # 256) and past 256 (256-column panels: bf16 on wgmma, f32 on CUDA
    # cores), bf16 also at PAST_BF16_HEAD_DIMS
    cases += [(dtype, causal, 8, t, t, dh, False)
              for dtype in ("bfloat16", "float32")
              for dh in (*WIDE_HEAD_DIMS, PAST_HEAD_DIM)
              for causal in (True, False) for t in (100, 257)]
    cases += [(dtype, False, 8, 100, 257, dh, False)
              for dtype in ("bfloat16", "float32")
              for dh in (*WIDE_HEAD_DIMS, PAST_HEAD_DIM)]
    cases += [("bfloat16", causal, 8, t, t, dh, False)
              for dh in PAST_BF16_HEAD_DIMS
              for causal in (True, False) for t in (100, 257)]
    cases += [("bfloat16", False, 8, tq, tk, dh, False)
              for dh in PAST_BF16_HEAD_DIMS
              for tq, tk in ((100, 257), (257, 100))]
    # the training shapes, checked and timed: the probe's (Dh 64), the
    # dim-1024 model's (Dh 128) and the dim-2048 model's (Dh 256, with
    # 192, 320 and 512 beside it), in both dtypes; at B*H 256 also Dh 16,
    # 80 and 96 (lm96's shape) beside 32
    cases += [(dtype, True, bh, TRAIN_T, TRAIN_T, dh, True)
              for bh, dh in ((TRAIN_BH, TRAIN_DH), (DH128_BH, 128),
                             (DH128_BH, 16), (DH128_BH, 32), (DH128_BH, 80),
                             (DH128_BH, 96),
                             (DH256_BH, 192), (DH256_BH, 256),
                             *((DH256_BH, dh)
                               for dh in PAST_TIMED_HEAD_DIMS))
              for dtype in ("bfloat16", "float32")]
    # and the dim-2048 model's serving joins in f32 (B*H 8, Dh 256, the
    # lengths of lm256's first four prompts), after its training shape
    cases += [("float32", True, 8, t, t, 256, True)
              for t in PROMPT_LENS[:4]]
    rows = []
    for dtype_name, causal, bh, tq, tk, dh, timed in cases:
        dtype = getattr(torch, dtype_name)
        q = torch.randn((bh, tq, dh), generator=gen, device="cuda").to(dtype)
        k = torch.randn((bh, tk, dh), generator=gen, device="cuda").to(dtype)
        v = torch.randn((bh, tk, dh), generator=gen, device="cuda").to(dtype)
        scale = dh ** -0.5
        (o, lse), kernel = launched(
            lambda: flash_fwd_cuda(q, k, v, causal, scale))
        torch.cuda.synchronize()
        rows.append(_k1_check(torch, flash_fwd_plain(q, k, v, causal, scale),
                              (o, lse), dtype_name, causal, bh, tq, tk, dh))
        rows[-1]["kernel"] = kernel
        if timed:
            row = rows[-1]
            qs, ks, vs = (x.view(1, bh, -1, dh) for x in (q, k, v))
            row["ms"] = device_ms(
                lambda: flash_fwd_cuda(q, k, v, causal, scale))
            row["plain_ms"] = device_ms(
                lambda: flash_fwd_plain(q, k, v, causal, scale))
            row["library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                       is_causal=causal))
            row["bound_ms"], row["bound_by"] = flash_bound(
                bh, tq, tk, dh, causal, q.element_size())
        emit({"phase": "k1", **rows[-1]})
        del q, k, v, o, lse
    # a batch-1 join in bf16, through the op the model calls: (B, T, H, Dh)
    # in, the (B*H, T, Dh) copies of _to_bh handed to the kernel
    q, k, v = (torch.randn((1, 200, 8, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    (o, lse), kernel = launched(lambda: flash_attention_lse(q, k, v, True))
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_fwd_plain(_to_bh(q), _to_bh(k), _to_bh(v), True,
                                     64 ** -0.5)
    rows.append(_k1_check(torch, (o_ref, lse_ref),
                          (_to_bh(o), lse.reshape(8, 200)), "bfloat16",
                          True, 8, 200, 200, 64))
    rows[-1].update(kernel=kernel, join_batch_1=True)
    emit({"phase": "k1", **rows[-1]})
    _k1_tf32_control(torch)
    return rows


def _k1_tf32_control(torch):
    """The f32 K1 on tensor cores (grids that fill the card) is 3xTF32,
    not one TF32 pass: on Q and K with a common offset of 1 (scores near
    64·scale, whose differences TF32's three digits blur) the kernel is
    within the f32 bound of 1e-5 of causal attention computed in float64,
    and the plain version with TF32 products (``allow_tf32``) misses it by
    far; at Dh 192 and 256 (B·H 128, T 200) the same of the eight-warp
    kernel (``flash_fwd_f32_wide``), S summed over 32 k-steps.  The
    witness is float64, not the plain version in f32: at Dh 128 on these
    inputs that is itself 1.1e-5 from float64 in O (an H100).  Each row
    also gives the plain f32 version's distance and the kernel's from
    it."""
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_fwd_cuda, flash_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for bh, t, dh, want in ((136, 200, 128, "flash_fwd_f32"),
                            (64, 512, 64, "flash_fwd_f32"),
                            (64, 512, 32, "flash_fwd_f32"),
                            (DH256_BH, 200, 192, "flash_fwd_f32_wide"),
                            (DH256_BH, 200, 256, "flash_fwd_f32_wide")):
        q, k = (torch.randn((bh, t, dh), generator=gen, device="cuda") + 1.0
                for _ in range(2))
        v = torch.randn((bh, t, dh), generator=gen, device="cuda")
        exact = attention_float64(torch, q, k, v, True, dh ** -0.5)
        plain = flash_fwd_plain(q, k, v, True, dh ** -0.5)
        got, kernel = launched(
            lambda: flash_fwd_cuda(q, k, v, True, dh ** -0.5))
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = flash_fwd_plain(q, k, v, True, dh ** -0.5)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

        def err(a, b):
            return {"o": _max_err(a[0], b[0]), "lse": _max_err(a[1], b[1])}
        rows.append({"phase": "k1_tf32_control", "bh": bh, "t": t, "dh": dh,
                     "causal": True, "kernel": kernel, "want": want,
                     "witness": "float64",
                     "tol": {"atol": 1e-5}, "kernel_err": err(got, exact),
                     "plain_f32_err": err(plain, exact),
                     "one_tf32_pass_err": err(tf32, exact),
                     "kernel_vs_plain_f32": err(got, plain)})
        emit(rows[-1])
    check(all(r["kernel"] == r["want"] and
              max(r["kernel_err"].values()) <= 1e-5
              < min(r["one_tf32_pass_err"].values()) for r in rows),
          f"the f32 K1 is not held apart from one TF32 pass: {rows}")


def attention_float64(torch, q, k, v, causal, scale):
    """Attention's (O, lse) computed in float64 on (BH, T, Dh) inputs: the
    witness the f32 versions are measured from."""
    s = torch.matmul(q.double(), k.double().transpose(1, 2)) * scale
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool,
                                     device=s.device).triu(1), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return torch.matmul(torch.exp(s - lse[..., None]), v.double()), lse


def _p_ds_float64(torch, q, k, v, lse, do, dvec, causal, scale):
    """P and dS of the backward in float64 from the same inputs (L and D
    as given), with q, k, dO in float64."""
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    p = torch.exp(qd @ kd.transpose(1, 2) * scale - lse.double()[..., None])
    if causal:
        p = p.masked_fill(torch.ones(p.shape[-2:], dtype=torch.bool,
                                     device=p.device).triu(1), 0.0)
    ds = p * (dod @ vd.transpose(1, 2) - dvec.double()[..., None]) * scale
    return p, ds, qd, kd, dod


def dq_float64(torch, *args):
    """K2's dQ computed in float64 from ``flash_bwd_plain``'s arguments:
    the witness the f32 versions are measured from."""
    _, ds, _, kd, _ = _p_ds_float64(torch, *args)
    return ds @ kd


def dkv_float64(torch, *args):
    """K3's (dK, dV) computed in float64 from ``flash_bwd_plain``'s
    arguments: the witness the f32 versions are measured from."""
    p, ds, qd, _, dod = _p_ds_float64(torch, *args)
    return ds.transpose(1, 2) @ qd, p.transpose(1, 2) @ dod


def _wide_bwd_tf32_control(torch):
    """The f32 K2 and K3 past head dim 128 (at 192 and 256 their eight-warp
    kernels, at 320 and 512 their panels) are 3xTF32, not one TF32
    pass: on Q and K with a common offset of 1 their dQ (K2) and dK, dV
    (K3) are within ``GRAD_TOL``'s f32 bound of K2 and K3 computed in
    float64 (``dq_float64``, ``dkv_float64``), and the plain version with
    TF32 products (``allow_tf32``) misses it.  The witness is float64
    because on these inputs the plain version in f32 can itself be
    outside that bound; each row gives its distance too.  Emits one
    ``k2_tf32_control`` and one ``k3_tf32_control`` row a case."""
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_plain,
        flash_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(7)
    tol = GRAD_TOL["float32"]
    rows = []
    for causal, tq, tk, dh in ((True, 200, 200, 192), (True, 200, 200, 256),
                               (False, 64, 130, 256), (True, 200, 200, 320),
                               (True, 200, 200, 512), (False, 64, 130, 512)):
        q, do = (torch.randn((8, tq, dh), generator=gen, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn((8, tk, dh), generator=gen, device="cuda")
                for _ in range(2))
        q, k = q + 1.0, k + 1.0
        o, lse = flash_fwd_plain(q, k, v, causal, dh ** -0.5)
        args = (q, k, v, lse, do, (do * o).sum(-1), causal, dh ** -0.5)
        plain = flash_bwd_plain(*args)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = flash_bwd_plain(*args)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        dq, dq_kernel = launched(lambda: flash_bwd_dq_cuda(*args))
        dkv, dkv_kernel = launched(lambda: flash_bwd_dkv_cuda(*args))
        route = "wide" if dh <= 256 else "past256"
        # (phase, output names, their slice of (dQ, dK, dV), kernel ran,
        # outputs, float64 witness, kernel wanted)
        for phase, names, cut, kernel, got, exact, want in (
                ("k2_tf32_control", ("dq",), slice(0, 1), dq_kernel, (dq,),
                 (dq_float64(torch, *args),), f"flash_bwd_dq_f32_{route}"),
                ("k3_tf32_control", ("dk", "dv"), slice(1, 3), dkv_kernel,
                 dkv, dkv_float64(torch, *args),
                 f"flash_bwd_dkv_f32_{route}")):

            def err(a):
                return {n: _max_err(x, r)
                        for n, x, r in zip(names, a, exact)}

            def within(a):
                return all(_within(x, r, **tol) for x, r in zip(a, exact))
            rows.append({"phase": phase, "bh": 8, "tq": tq, "tk": tk,
                         "dh": dh, "causal": causal, "kernel": kernel,
                         "want": want, "witness": "float64", "tol": tol,
                         "kernel_err": err(got),
                         "kernel_within": within(got),
                         "plain_f32_err": err(plain[cut]),
                         "plain_f32_within": within(plain[cut]),
                         "one_tf32_pass_err": err(tf32[cut]),
                         "one_tf32_pass_within": within(tf32[cut])})
            emit(rows[-1])
    check(all(r["kernel"] == r["want"] and r["kernel_within"]
              and not r["one_tf32_pass_within"] for r in rows),
          f"the f32 K2/K3 past Dh 128 are not held apart from one TF32 "
          f"pass: {rows}")


#: the kernels each dtype's K1, K2 and K3 run past Dh 256
PAST256_KERNELS = {
    "float32": ("flash_fwd_cuda_cores", "flash_bwd_dq_f32_past256",
                "flash_bwd_dkv_f32_past256"),
    "bfloat16": ("flash_fwd_wgmma_past256", "flash_bwd_dq_wgmma_past256",
                 "flash_bwd_dkv_wgmma_past256")}


def phase_past256(torch):
    """K1, K2 and K3 at Dh ``PAST_HEAD_DIM`` (320: two 256-column panels,
    as the reference's BlockSpecs span any head dim; f32 K1 on CUDA
    cores and K2, K3 as 3xTF32, bf16 on wgmma: ``PAST256_KERNELS``), in
    both dtypes, through the
    differentiable op a model calls (``flash_attention_lse``, then
    autograd with an lse cotangent), against the plain versions on the
    same inputs: one launch each, of the kernels the dtype routes to, O
    and lse (f32 within 1e-5) and dQ, dK, dV within ``GRAD_TOL``.  Emits a
    row per dtype; returns the path's launches by kernel (counts set to 0
    just before, read just after)."""
    from collections import Counter
    from distkeras_tpu_torch.ops.flash_attention import (
        KERNEL_LAUNCHES, _to_bh, flash_attention_lse, flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda, flash_bwd_plain, flash_fwd_cuda, flash_fwd_plain,
        reset_launches)
    kernels = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, t, h, dh = 2, 200, 4, PAST_HEAD_DIM
    reset_launches()
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        q, k, v, g = (torch.randn((b, t, h, dh), generator=gen,
                                  device="cuda").to(dtype)
                      for _ in range(4))
        g_lse = torch.randn((b, h, t), generator=gen, device="cuda")
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        before = [fn.launches for fn in kernels]
        ran_before = Counter(KERNEL_LAUNCHES)
        out, lse = flash_attention_lse(q, k, v, True)
        grads = torch.autograd.grad((out, lse), (q, k, v), (g, g_lse))
        torch.cuda.synchronize()
        launches = [fn.launches - n for fn, n in zip(kernels, before)]
        ran = sorted(n for n, _, _ in KERNEL_LAUNCHES - ran_before)
        qb, kb, vb, ob, gb = (_to_bh(x.detach()) for x in (q, k, v, out, g))
        scale = dh ** -0.5
        o_ref, lse_ref = flash_fwd_plain(qb, kb, vb, True, scale)
        dvec = (gb.float() * ob.float()).sum(-1) - g_lse.reshape(b * h, t)
        refs = flash_bwd_plain(qb, kb, vb, lse.detach().reshape(b * h, t),
                               gb, dvec, True, scale)
        got = [_to_bh(x) for x in grads]
        tol = GRAD_TOL[dtype_name]
        row = {"phase": "past256", "dtype": dtype_name, "bh": b * h,
               "t": t, "dh": dh, "causal": True, "launches": launches,
               "o_err": _max_err(_to_bh(out), o_ref),
               "lse_err": _max_err(lse.reshape(b * h, t), lse_ref),
               "dq_err": _max_err(got[0], refs[0]),
               "dk_err": _max_err(got[1], refs[1]),
               "dv_err": _max_err(got[2], refs[2]), "tol": tol,
               "kernels": ran}
        emit(row)
        if dtype_name == "float32":
            fwd_ok = max(row["o_err"], row["lse_err"]) <= 1e-5
        else:
            fwd_ok = all(_within(a, r, **tol) for a, r in (
                (_to_bh(out), o_ref), (lse.reshape(b * h, t), lse_ref)))
        check(launches == [1, 1, 1] and fwd_ok and
              ran == sorted(PAST256_KERNELS[dtype_name]) and
              all(bool(torch.isfinite(x.float()).all()) and
                  _within(x, r, **tol) for x, r in zip(got, refs)),
              f"K1-K3 at head dim {dh} disagree with the plain versions, "
              f"launched other than once each or other kernels than "
              f"{PAST256_KERNELS[dtype_name]}: {row}")
    return kernel_launches()


def _k1_check(torch, ref, got, dtype_name, causal, bh, tq, tk, dh):
    """K1's (O, lse) against the plain version's: f32 within 1e-5 of
    each value, bf16 within ``GRAD_TOL``'s bf16 bound (rtol 1e-2 plus
    1e-2 of the largest |value|), both finite.  Returns the case's row."""
    (o_ref, lse_ref), (o, lse) = ref, got
    err = max(_max_err(o, o_ref), _max_err(lse, lse_ref))
    row = {"dtype": dtype_name, "causal": causal, "bh": bh, "tq": tq,
           "tk": tk, "dh": dh, "max_abs_err": err}
    if dtype_name == "float32":
        row["tol"] = {"atol": 1e-5}
        ok = err <= 1e-5
    else:
        row["tol"] = GRAD_TOL["bfloat16"]
        ok = all(_within(a, b, **row["tol"])
                 for a, b in ((o, o_ref), (lse, lse_ref)))
    check(ok and bool(torch.isfinite(o.float()).all()),
          f"K1 disagrees with its plain version: {row}")
    return row


def serve_traffic(model, prompts, window=None):
    """Warm a fresh engine up, then serve ``prompts`` (the first four at
    once, the rest once decoding is under way, so they join as the short
    requests free their slots, mid-decode for the others).  ``window``
    (a context manager) wraps the served traffic only.  Returns the
    registry, the requests, the wall seconds and the kernel's launches
    in warmup and in the served traffic, and the served traffic's
    ``kernel_launches``."""
    import contextlib
    from distkeras_tpu_torch.obs import Registry
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_fwd_cuda, reset_launches)
    from distkeras_tpu_torch.serve import DecodeEngine, ServeConfig

    registry = Registry()
    engine = DecodeEngine(model, ServeConfig(slots=4, max_new_tokens=64),
                          registry=registry)
    reset_launches()
    engine.warmup()
    warmup_launches = flash_fwd_cuda.launches
    # the main path: counts set to 0 just before, read just after
    reset_launches()
    with window if window is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        engine.start()
        try:
            reqs = [engine.submit(p, max_new_tokens=m)
                    for p, m in zip(prompts[:4], MAX_NEW[:4])]
            check(_wait_first_token(reqs[0], 120),
                  "no first token within 120 s")
            reqs += [engine.submit(p, max_new_tokens=m)
                     for p, m in zip(prompts[4:], MAX_NEW[4:])]
            for r in reqs:
                r.result(timeout=300)
        finally:
            engine.stop()
        wall = time.perf_counter() - t0
    return (registry, reqs, wall, warmup_launches, flash_fwd_cuda.launches,
            kernel_launches())


def phase_slice(torch, model, prompts):
    """Serve 8 greedy requests on the card and hold them to the checks."""
    import numpy as np
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_fwd_cuda, reset_launches)

    (registry, reqs, wall, warmup_launches, served_launches,
     served_kernels) = serve_traffic(model, prompts)
    answers = [r.result() for r in reqs]
    snap = registry.snapshot()
    joins = int(snap["serve.joins"]["value"])

    # (a) each answer against the port's generate_tokens on the card
    reset_launches()
    mismatches = _answers_match(torch, model, prompts, answers)
    reference_launches = flash_fwd_cuda.launches

    # (b) flash vs dense first-token logits on the same weights
    dense = zoo.gpt_lm(**{**LM, "attention_impl": "dense"}).init(seed=1)
    dense.load_state_dict(model.state_dict())
    logit_err = 0.0
    with torch.no_grad():
        for p in (prompts[2], prompts[7]):
            x = torch.as_tensor(p)[None].cuda()
            logit_err = max(logit_err, (model(x)[0, -1] - dense(x)[0, -1])
                            .abs().max().item())
    check(logit_err <= 1e-4, f"flash vs dense logits differ by {logit_err}")

    # (c) the served traffic went through the kernel: 4 blocks per join
    check(joins == len(prompts) and served_launches == 4 * joins,
          f"flash_fwd launches {served_launches} != 4 x {joins} joins")
    # (d) no new program signature after warmup
    retraces = int(snap["jit.retraces"]["value"])
    check(retraces == 0, f"jit.retraces == {retraces} after warmup")

    ttft = [r.first_token_t - r.submit_t for r in reqs]
    per_tok = [(r.done_t - r.first_token_t) / max(len(r.tokens) - 1, 1)
               for r in reqs]
    tokens = int(snap["serve.tokens_out"]["value"])
    row = {"phase": "slice", "model": LM, "slots": 4, "requests": len(reqs),
           "joins": joins, "tokens": tokens, "wall_s": wall,
           "ttft_ms_p50": 1e3 * float(np.median(ttft)),
           "ttft_ms_max": 1e3 * float(np.max(ttft)),
           "step_ms_p50": 1e3 * registry.get(
               "serve.step_seconds").quantile(0.5),
           "per_token_ms_p50": 1e3 * float(np.median(per_tok)),
           "tokens_per_s": tokens / wall,
           "launches": {"warmup": warmup_launches,
                        "served": served_launches,
                        "generate_tokens": reference_launches},
           "kernel_launches": served_kernels,
           "mismatches": mismatches, "flash_vs_dense_logit_err": logit_err,
           "jit_retraces": retraces,
           "jit_compiles": int(snap["jit.compiles"]["value"])}
    emit(row)
    return row


def _answers_match(torch, model, prompts, answers, news=MAX_NEW):
    """Each served answer against the port's ``generate_tokens`` of
    ``model`` on its device (``news`` tokens a request, ``MAX_NEW`` by
    default): a mismatch is allowed only where the reference's top-2
    logit gap is < 1e-4.  Returns the mismatches."""
    import numpy as np
    from distkeras_tpu_torch.models import generate_tokens
    mismatches = []
    for i, (p, m, got) in enumerate(zip(prompts, news, answers)):
        ref = generate_tokens(model, p[None, :], m, device=model.device)[
            0, len(p):].cpu().numpy()
        check(got.shape == ref.shape, f"request {i}: {got.shape} tokens, "
              f"expected {ref.shape}")
        diff = np.nonzero(got != ref)[0]
        if diff.size:
            step = int(diff[0])
            seq = torch.as_tensor(np.concatenate([p, ref]))[None].to(
                model.device)
            with torch.no_grad():
                logits = model(seq)[0, len(p) - 1 + step]
            top2 = torch.topk(logits, 2).values
            gap = float(top2[0] - top2[1])
            mismatches.append({"request": i, "step": step, "gap": gap})
            check(gap < 1e-4, f"request {i} differs from generate_tokens at "
                  f"step {step} where the top-2 gap is {gap}")
    return mismatches


def phase_profile(torch, model, prompts):
    """The same traffic again under a ``torch.profiler`` CUDA trace: the
    card's busy share of the served wall and where its time goes."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    _, reqs, wall, _, launches, _ = serve_traffic(model, prompts,
                                                  window=prof)
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if not events:
        # served once (the serving state moves): not taken again
        _profiler_gap("profile", "not measured")
    flash_us = sum(e.self_device_time_total for e in events
                   if "flash_fwd_" in e.key)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    row = {"phase": "profile", "wall_s": wall,
           "device_busy_s": busy_us / 1e6 if events else None,
           "device_busy_share": busy_us / 1e6 / wall if events else None,
           "flash_fwd_share_of_device": flash_us / busy_us if busy_us else None,
           "flash_fwd_launches": launches,
           "top_kernels": [{"name": e.key[:90], "count": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in top]}
    emit(row)
    return row


#: the ``fleet`` phase: 2 ServeServers over prefix-cached engines behind a
#: ServeRouter with the KV fabric, 4 prompt groups of a 256-token shared
#: prefix and 16-token tails, 16 new tokens a request
FLEET = dict(engines=2, slots=4, prefix_block=16, prefix_cache_mb=512,
             max_inflight=4, groups=4, prefix=256, tail=16, max_new=16,
             warm_per_group=3, sampled=8)
#: the ``spec`` phase: 8 greedy requests of 32-96 tokens, 32 new tokens,
#: ``spec_k`` 4; the narrow draft is gpt_lm(dim 128, 2 heads of Dh 64, 2
#: blocks)
SPEC_PROMPT_LENS = (32, 40, 48, 56, 64, 72, 80, 96)
SPEC_NEW, SPEC_K = 32, 4
SPEC_DRAFT = dict(LM, dim=128, num_heads=2, num_blocks=2)
#: the ``beam`` phase: 2 prompts of 64 tokens, 4 beams, 16 steps
BEAM = dict(batch=2, prompt=64, num_beams=4, steps=16)


def _k1_at(torch, seed, bh, t, dh, causal=True):
    """K1 (f32) against its plain version at one shape a later path
    launches it at, on inputs from ``seed``; the row for the ``kernels``
    line."""
    from distkeras_tpu_torch.ops.flash_attention import (flash_fwd_cuda,
                                                         flash_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((bh, t, dh), generator=gen, device="cuda")
               for _ in range(3))
    (o, lse), kernel = launched(lambda: flash_fwd_cuda(q, k, v, causal,
                                                       dh ** -0.5))
    torch.cuda.synchronize()
    row = _k1_check(torch, flash_fwd_plain(q, k, v, causal, dh ** -0.5),
                    (o, lse), "float32", causal, bh, t, t, dh)
    row["kernel"] = kernel
    return row


def _concurrently(fn, args):
    """``fn(arg)`` for every arg on its own thread; the results in order
    (a failure in any call is raised here)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(args)) as pool:
        return list(pool.map(fn, args))


def _busy_us(prof):
    """The union of the device's intervals in ``prof``'s trace, µs."""
    busy, reached = 0.0, 0.0
    for start, end, _ in sorted(device_events(prof)):
        busy += max(0.0, end - max(start, reached))
        reached = max(reached, end)
    return busy


def phase_fleet(torch, model):
    """The serving plane on the card: ``FLEET["engines"]`` ServeServers
    over prefix-cached engines (copies of the probe ``model``, f32)
    behind a ServeRouter with the KV fabric, driven by ServeClients over
    loopback.  Traffic: a serialized cold pass (one request a group), 3
    warm requests a group at once (then the same under the profiler, for
    the busy share), a forced spill a group (the owner pinned at
    ``max_inflight``: the spill lands cold and seeds a replication; a
    second spill lands warm on the replica), a planned drain of one
    engine (its hot KV migrates; a follow-up a group lands warm), a fleet
    promote while that engine is out (then it is scaled up and rolled
    forward, and a kv_push stamped with the old version is refused), and
    8 sampled requests.  Checks: greedy answers equal ``generate_tokens``,
    router accounting exact, prefix hits and misses as the passes
    dictate, replications happened, no stale join, K1 launched exactly
    ``num_blocks`` x cold joins (the engines' ``serve.prefix.misses``)."""
    import copy
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.obs import Registry
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_fwd_cuda, reset_launches)
    from distkeras_tpu_torch.serve import (
        DecodeEngine, RouterConfig, ServeClient, ServeConfig, ServeRouter,
        ServeServer)
    from distkeras_tpu_torch.utils import to_numpy_variables

    f = FLEET
    cfg = ServeConfig(slots=f["slots"], prefix_cache=True,
                      prefix_block=f["prefix_block"],
                      prefix_cache_mb=f["prefix_cache_mb"])
    servers = [ServeServer(DecodeEngine(copy.deepcopy(model), cfg,
                                        registry=Registry()).warmup())
               .start() for _ in range(f["engines"])]
    router = ServeRouter(
        [("127.0.0.1", srv.port) for srv in servers],
        config=RouterConfig(affinity_block=f["prefix_block"],
                            max_inflight=f["max_inflight"])).start()
    rng = np.random.default_rng(14)
    vocab = LM["vocab_size"]
    shared = [rng.integers(0, vocab, f["prefix"]) for _ in range(f["groups"])]

    def prompt(g):
        return np.concatenate([shared[g], rng.integers(0, vocab, f["tail"])])

    def generate(p, **kw):
        with ServeClient("127.0.0.1", router.port) as c:
            reply = c.generate(p, f["max_new"], **kw)
        check(reply.get("ok"), f"fleet request failed: {reply}")
        return reply

    def prefix_counts():
        snaps = [srv.engine.registry.snapshot() for srv in servers]
        return tuple(int(sum(sn[f"serve.prefix.{n}"]["value"]
                             for sn in snaps)) for n in ("misses", "hits"))

    greedy = []                          # (prompt, reply), pre-promote
    row = {"phase": "fleet", "model": LM, **f}
    # the main path: counts set to 0 just before, read just after
    reset_launches()
    client = ServeClient("127.0.0.1", router.port)
    try:
        # 1) a serialized cold pass: one request a group
        owners, cold_ttft = [], []
        for g in range(f["groups"]):
            p = prompt(g)
            reply = client.generate(p, f["max_new"])
            check(reply.get("ok") and reply["warm"] is False,
                  f"cold pass, group {g}: {reply}")
            greedy.append((p, reply))
            owners.append(reply["engine"])
            cold_ttft.append(reply["ttft_s"])
        check(prefix_counts() == (f["groups"], 0),
              f"prefix (misses, hits) after the cold pass: "
              f"{prefix_counts()}")
        # 2) the warm pass: each group's requests at once, on its owner
        warm_ttft, t0 = [], time.perf_counter()
        for g in range(f["groups"]):
            ps = [prompt(g) for _ in range(f["warm_per_group"])]
            for p, reply in zip(ps, _concurrently(generate, ps)):
                check(reply["warm"] is True and reply["engine"] == owners[g],
                      f"warm pass, group {g}: {reply}")
                greedy.append((p, reply))
                warm_ttft.append(reply["ttft_s"])
        warm_wall = time.perf_counter() - t0
        n_warm = f["groups"] * f["warm_per_group"]
        check(prefix_counts() == (f["groups"], n_warm),
              f"prefix (misses, hits) after the warm pass: "
              f"{prefix_counts()}")
        # the same pass again under the profiler: the card's busy share
        prof = profile(activities=[ProfilerActivity.CUDA])
        with prof:
            t0 = time.perf_counter()
            for g in range(f["groups"]):
                ps = [prompt(g) for _ in range(f["warm_per_group"])]
                for p, reply in zip(ps, _concurrently(generate, ps)):
                    greedy.append((p, reply))
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        # the pass moves the prefix counts, so an empty trace is not taken
        # again: the busy share is then not measured
        busy_us = _busy_us(prof) if device_events(prof) else None
        if busy_us is None:
            _profiler_gap("fleet", "not measured")
        else:
            check(busy_us > 0, "the fleet trace holds no device time")
        check(prefix_counts() == (f["groups"], 2 * n_warm),
              f"prefix (misses, hits) after the profiled pass: "
              f"{prefix_counts()}")
        # 3) a forced spill a group: cold, replicated, then warm
        spill_cold, spill_warm = [], []
        for g in range(f["groups"]):
            owner = next(b for b in router.backends if b.addr == owners[g])
            with router._lock:
                owner.inflight += f["max_inflight"]
            try:
                p = prompt(g)
                first = client.generate(p, f["max_new"])
                check(first.get("ok") and first["warm"] is False
                      and first["engine"] != owners[g],
                      f"spill {g} did not land cold elsewhere: {first}")
                greedy.append((p, first))
                spill_cold.append(first["ttft_s"])
                t_end = time.monotonic() + 60
                while router.registry.counter(
                        "serve.router.kv_replications").value < g + 1:
                    check(time.monotonic() < t_end,
                          f"group {g}: no replication within 60 s")
                    time.sleep(0.01)
                p = prompt(g)
                second = client.generate(p, f["max_new"])
                check(second.get("ok") and second["warm"] is True
                      and second["engine"] == first["engine"],
                      f"spill {g} did not land warm on the replica: "
                      f"{second}")
                greedy.append((p, second))
                spill_warm.append(second["ttft_s"])
            finally:
                with router._lock:
                    owner.inflight -= f["max_inflight"]
        n = f["groups"]
        check(prefix_counts() == (2 * n, 2 * n_warm + n),
              f"prefix (misses, hits) after the spills: {prefix_counts()}")
        # 4) a planned drain of one engine: its hot KV migrates first
        keep, victim = servers[0], servers[1]
        with ServeClient("127.0.0.1", keep.port) as c0:
            stale_doc = c0.kv_fetch(prompt=greedy[0][0])
        check(stale_doc.get("found") and stale_doc["version"] == 0,
              "no exportable entry for the stale-push check")
        drained = client.drain(engine=f"127.0.0.1:{victim.port}")
        check(drained.get("ok") and drained.get("drained")
              and drained.get("migrated", 0) >= 1,
              f"planned drain: {drained}")
        for g in range(f["groups"]):
            p = prompt(g)
            reply = client.generate(p, f["max_new"])
            check(reply.get("ok") and reply["warm"] is True
                  and reply["engine"] == f"127.0.0.1:{keep.port}",
                  f"after the drain, group {g}: {reply}")
            greedy.append((p, reply))
        check(prefix_counts() == (2 * n, 2 * n_warm + 2 * n),
              f"prefix (misses, hits) after the drain: {prefix_counts()}")
        # 5) a fleet promote while the victim is out, then scale it up:
        # it is rolled forward; a push stamped with the old version is
        # refused
        new_vars = to_numpy_variables(zoo.gpt_lm(**LM).init(1,
                                                            device="cpu"))
        promoted = client.promote(new_vars)
        check(promoted["promoted"] == 1 and promoted["failed"] == 1,
              f"fleet promote: {promoted}")
        t_end = time.monotonic() + 30
        while keep.engine.kv_version != 1:
            check(time.monotonic() < t_end, "promotion never adopted")
            time.sleep(0.01)
        with ServeClient("127.0.0.1", keep.port) as c0:
            pushed = c0.kv_push(stale_doc["entries"], stale_doc["version"])
        check(pushed["joined"] == 0 and pushed["refused_stale"] == 1,
              f"a stale kv_push was not refused: {pushed}")
        up = client.undrain(engine=f"127.0.0.1:{victim.port}")
        check(up.get("ok"), f"scale-up of the drained engine: {up}")
        check(router.registry.counter(
            "serve.router.promote_rollforwards").value == 1,
            "the rejoining engine was not rolled forward")
        t_end = time.monotonic() + 30
        while victim.engine.kv_version != 1:
            check(time.monotonic() < t_end, "roll-forward never adopted")
            time.sleep(0.01)
        # 6) sampled requests through the router, each to max_new tokens
        ps = [rng.integers(0, vocab, 100) for _ in range(f["sampled"])]
        sampled = _concurrently(
            lambda p: generate(p, temperature=0.8, top_k=50), ps)
        check(all(len(r["tokens"]) == f["max_new"] for r in sampled),
              "a sampled request ended short")
        torch.cuda.synchronize()
        served = flash_fwd_cuda.launches
        row["kernel_launches"] = kernel_launches()
        misses, hits = prefix_counts()
        snap = router.registry.snapshot()
        fleet_stats = client.stats()
    finally:
        client.close()
        router.stop()
        for srv in servers:
            srv.stop()
    val = lambda name: int(snap[name]["value"])  # noqa: E731
    check(misses == 2 * n + f["sampled"],
          f"cold joins {misses} != {2 * n + f['sampled']}")
    check(served == LM["num_blocks"] * misses,
          f"flash_fwd launches {served} != {LM['num_blocks']} x {misses} "
          f"cold joins")
    accounting = {"requests": val("serve.router.requests"),
                  "completed": val("serve.router.completed"),
                  "rejected": val("serve.router.rejected"), "timeouts": 0}
    check(accounting["requests"] == accounting["completed"]
          + accounting["rejected"] + accounting["timeouts"]
          and accounting["rejected"] == 0,
          f"router accounting broken: {accounting}")
    check(val("serve.router.kv_replications") >= n,
          f"replications: {val('serve.router.kv_replications')}")
    check(val("serve.router.kv_refused_stale") == 0,
          "the fabric pushed stale KV")
    mismatches = _answers_match(torch, model, [p for p, _ in greedy],
                                [np.asarray(r["tokens"]) for _, r in greedy],
                                news=[f["max_new"]] * len(greedy))
    tokens = f["max_new"] * n_warm
    row.update({
        "requests": accounting["requests"], "accounting": accounting,
        "greedy_checked": len(greedy), "mismatches": mismatches,
        "prefix_cache": {"misses": misses, "hits": hits},
        "cold_joins": misses, "k1_launches": served,
        "ttft_ms_p50": {"cold": 1e3 * float(np.median(cold_ttft)),
                        "warm": 1e3 * float(np.median(warm_ttft)),
                        "spill_cold": 1e3 * float(np.median(spill_cold)),
                        "spill_warm": 1e3 * float(np.median(spill_warm))},
        "warm_pass_tokens_per_s": tokens / warm_wall,
        "warm_pass_wall_s": warm_wall,
        "device_busy_share": (None if busy_us is None
                              else busy_us / 1e6 / prof_wall),
        "profiled_wall_s": prof_wall,
        "kv_replications": val("serve.router.kv_replications"),
        "kv_migrations": val("serve.router.kv_migrations"),
        "kv_push_bytes": val("serve.router.kv_push_bytes"),
        "migrated_on_drain": drained["migrated"],
        "stale_push": pushed, "stale_joins": pushed["joined"],
        "promote_rollforwards": val("serve.router.promote_rollforwards"),
        "affinity_secondary_hits": val(
            "serve.router.affinity_secondary_hits"),
        "engines_alive": fleet_stats["engines_alive"],
        "jit_retraces": int(fleet_stats["stats"]["jit.retraces"]["value"])})
    check(row["jit_retraces"] == 0,
          f"jit.retraces == {row['jit_retraces']} in the fleet")
    emit(row)
    return row


def phase_spec(torch, model):
    """Speculative decoding on the card: the same 8 greedy requests
    (``SPEC_PROMPT_LENS``, ``SPEC_NEW`` new tokens) through a plain
    engine, a ``spec_k=4`` engine whose draft is the probe itself
    (accept rate 1.0) and one whose draft is ``SPEC_DRAFT`` (accepts
    below 1).  Every answer equals ``generate_tokens``; K1 launches are
    (target blocks + draft blocks) x cold joins.  Returns the row and
    the K1 checks at the draft's join shapes."""
    from collections import Counter
    import numpy as np
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.obs import Registry
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_fwd_cuda, reset_launches)
    from distkeras_tpu_torch.serve import DecodeEngine, ServeConfig

    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, LM["vocab_size"], n)
               for n in SPEC_PROMPT_LENS]
    narrow = zoo.gpt_lm(**SPEC_DRAFT).init(seed=2)
    runs, spec_rows = {}, Counter()
    for name, draft, draft_blocks in (
            ("plain", None, 0), ("self_draft", model, LM["num_blocks"]),
            ("narrow_draft", narrow, SPEC_DRAFT["num_blocks"])):
        registry = Registry()
        cfg = ServeConfig(slots=4, spec_k=0 if draft is None else SPEC_K)
        engine = DecodeEngine(model, cfg, registry=registry,
                              draft_model=draft).warmup()
        # this path: counts set to 0 just before, read just after
        reset_launches()
        t0 = time.perf_counter()
        with engine:
            reqs = [engine.submit(p, SPEC_NEW) for p in prompts]
            answers = [r.result(timeout=300) for r in reqs]
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = flash_fwd_cuda.launches
        if draft is not None:
            # both spec runs make the ``spec`` path of the kernels line
            spec_rows.update({tuple(r[:3]): r[3] for r in kernel_launches()})
        snap = registry.snapshot()
        joins = int(snap["serve.joins"]["value"])
        blocks = LM["num_blocks"] + draft_blocks
        check(joins == len(prompts) and launches == blocks * joins,
              f"spec {name}: flash_fwd launches {launches} != {blocks} x "
              f"{joins} joins")
        mismatches = _answers_match(torch, model, prompts, answers,
                                    news=[SPEC_NEW] * len(prompts))
        tokens = int(snap["serve.tokens_out"]["value"])
        runs[name] = {"tokens_per_s": tokens / wall, "wall_s": wall,
                      "steps": int(snap["serve.steps"]["value"]),
                      "accept_rate": snap["serve.spec.accept_rate"]["value"],
                      "proposed": int(snap["serve.spec.proposed"]["value"]),
                      "accepted": int(snap["serve.spec.accepted"]["value"]),
                      "k1_launches": launches, "blocks_per_join": blocks,
                      "mismatches": mismatches,
                      "jit_retraces": int(snap["jit.retraces"]["value"])}
        check(runs[name]["jit_retraces"] == 0,
              f"spec {name}: jit.retraces != 0")
    check(runs["self_draft"]["accept_rate"] == 1.0,
          f"self-draft accept rate {runs['self_draft']['accept_rate']}")
    check(runs["narrow_draft"]["accept_rate"] < 1.0,
          "the narrow draft accepted everything")
    # K1 at the narrow draft's joins (B*H 2, Dh 64, the buckets these
    # prompts take)
    dh = SPEC_DRAFT["dim"] // SPEC_DRAFT["num_heads"]
    checks = [_k1_at(torch, 15, SPEC_DRAFT["num_heads"], t, dh)
              for t in sorted({ServeConfig().bucket_for(n, LM["seq_len"])
                               for n in SPEC_PROMPT_LENS})]
    row = {"phase": "spec", "model": LM, "draft": SPEC_DRAFT,
           "spec_k": SPEC_K, "requests": len(prompts),
           "max_new": SPEC_NEW, **runs,
           "k1_checks": [{k: r[k] for k in ("kernel", "bh", "tq", "dh",
                                            "max_abs_err")}
                         for r in checks]}
    emit(row)
    return row, [[*key, n] for key, n in sorted(spec_rows.items())], checks


def phase_beam(torch, model):
    """``generate_beam`` on the probe (flash, f32) against its dense twin
    (the same weights): ``BEAM`` prompts and beams, equal tokens, scores
    within 1e-4; K1 once per block for the prefill.  Returns the row and
    the K1 check at the prefill's shape."""
    import numpy as np
    from distkeras_tpu_torch.models import generate_beam, zoo
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_fwd_cuda, reset_launches)

    b = BEAM
    x = np.random.default_rng(16).integers(0, LM["vocab_size"],
                                           (b["batch"], b["prompt"]))
    # the main path: counts set to 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    out, scores = generate_beam(model, x, b["steps"],
                                num_beams=b["num_beams"], return_scores=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_fwd_cuda.launches
    by_kernel = kernel_launches()
    check(launches == LM["num_blocks"],
          f"beam: flash_fwd launches {launches} != {LM['num_blocks']}")
    dense = zoo.gpt_lm(**{**LM, "attention_impl": "dense"}).init(seed=1)
    dense.load_state_dict(model.state_dict())
    ref, ref_scores = generate_beam(dense, x, b["steps"],
                                    num_beams=b["num_beams"],
                                    return_scores=True)
    score_err = (scores - ref_scores).abs().max().item()
    check(torch.equal(out, ref), "beam tokens differ from the dense twin's")
    check(score_err <= 1e-4, f"beam scores differ by {score_err}")
    check(out.shape == (b["batch"], b["prompt"] + b["steps"]),
          f"beam output shape {tuple(out.shape)}")
    rows = b["batch"] * b["num_beams"]
    k1 = _k1_at(torch, 16, rows * LM["num_heads"], LM["seq_len"],
                LM["dim"] // LM["num_heads"])
    row = {"phase": "beam", "model": LM, **b, "wall_s": wall,
           "tokens_per_s": b["batch"] * b["steps"] / wall,
           "scores": scores.tolist(), "score_err_vs_dense": score_err,
           "k1_launches": launches, "kernel_launches": by_kernel,
           "k1_check": {k: k1[k] for k in ("kernel", "bh", "tq", "dh",
                                           "max_abs_err")}}
    emit(row)
    return row, [k1]


def _max_err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def _within(got, ref, rtol, atol, atol_of_max) -> bool:
    got, ref = got.float(), ref.float()
    atol = atol + atol_of_max * ref.abs().max()
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


def _check_is_live(got, ref, tol) -> bool:
    """Whether ``_within`` fails for a copy of ``got`` whose value at the
    smallest |reference| is moved by 1e-4: the check can see an error
    there.  (An exact reading is no fault where a kernel and cuBLAS sum
    alike.)"""
    moved = got.float().clone().reshape(-1)
    moved[ref.float().abs().reshape(-1).argmin()] += 1e-4
    return not _within(moved.reshape(got.shape), ref, **tol)


def phase_k2k3(torch):
    """K2 and K3 against ``flash_bwd_plain`` on the card, then their times
    at the training shapes; returns the rows."""
    import torch.nn.functional as F
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_plain,
        flash_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(dtype, bh, tq, tk, dh, causal):
        """q, k, v, dO in ``dtype``; L from the plain forward and
        D = rowsum(dO∘O), f32 — the same inputs for kernel and plain."""
        q, do = (torch.randn((bh, tq, dh), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((bh, tk, dh), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        o, lse = flash_fwd_plain(q, k, v, causal, dh ** -0.5)
        dvec = (do.float() * o.float()).sum(-1)
        return (q, k, v, lse, do, dvec, causal, dh ** -0.5)

    cases = []
    for dtype in ("float32", "bfloat16"):
        cases += [(dtype, True, 8, t, t, 64) for t in (64, 100, 256, 512)]
        cases += [(dtype, False, 8, 256, 256, 32),
                  (dtype, False, 8, 100, 256, 64),
                  (dtype, True, 8, 100, 100, 32)]
    cases += [(dtype, True, 8, 257, 257, 64)
              for dtype in ("float32", "bfloat16")]
    cases += [("bfloat16", True, TRAIN_BH, TRAIN_T, TRAIN_T, 32)]
    for dtype in ("float32", "bfloat16"):
        cases += [(dtype, True, 8, t, t, 128) for t in (64, 257, 512)]
        cases += [(dtype, False, 8, 100, 256, 128)]
    # the f32 watch: long rows, where dK and dV sum the most query tiles
    # and dQ the most key tiles
    cases += [("float32", True, 4, t, t, dh) for t in (2048, 4096)
              for dh in (64, 128, 256)]
    # head dims between the tile widths (bf16 unpadded, f32 zero-padded),
    # and bf16 at head dims not a multiple of 8 (zero-padded to one)
    cases += [(dtype, causal, 8, 257, 257, dh)
              for dtype in ("float32", "bfloat16")
              for dh in BETWEEN_HEAD_DIMS for causal in (True, False)]
    cases += [(dtype, False, 8, 100, 256, dh)
              for dtype in ("float32", "bfloat16")
              for dh in BETWEEN_HEAD_DIMS]
    cases += [("bfloat16", causal, 8, 257, 257, dh) for dh in ODD_HEAD_DIMS
              for causal in (True, False)]
    # head dims past 128 (bf16 K2, K3 on wgmma and f32 K2, K3 as 3xTF32 up
    # to 256; f32 also at Dh % 4 != 0, read by 4-byte loads) and past 256
    # (256-column panels: bf16 K2, K3 on wgmma, flash_bwd_dq_wgmma_past256
    # and flash_bwd_dkv_wgmma_past256, also at PAST_BF16_HEAD_DIMS; f32 as
    # 3xTF32, flash_bwd_dq_f32_past256 and flash_bwd_dkv_f32_past256, also
    # at PAST_F32_ODD_HEAD_DIM)
    cases += [(dtype, causal, 8, 257, 257, dh)
              for dtype in ("float32", "bfloat16")
              for dh in (*WIDE_HEAD_DIMS, PAST_HEAD_DIM)
              for causal in (True, False)]
    cases += [(dtype, False, 8, 100, 256, dh)
              for dtype in ("float32", "bfloat16")
              for dh in (*WIDE_HEAD_DIMS, PAST_HEAD_DIM)]
    cases += [("bfloat16", causal, 8, 257, 257, dh)
              for dh in PAST_BF16_HEAD_DIMS for causal in (True, False)]
    cases += [("bfloat16", False, 8, 100, 256, dh)
              for dh in PAST_BF16_HEAD_DIMS]
    cases += [("float32", causal, 8, 257, 257, dh)
              for dh in (*WIDE_ODD_HEAD_DIMS, PAST_F32_ODD_HEAD_DIM)
              for causal in (True, False)]
    cases += [("float32", False, 8, 100, 256, dh)
              for dh in (*WIDE_ODD_HEAD_DIMS, PAST_F32_ODD_HEAD_DIM)]
    def checked(dtype_name, causal, bh, tq, tk, dh, args):
        """K2 and K3 on ``args`` against the plain version; the row, with
        the kernel each launched."""
        dq, dq_kernel = launched(lambda: flash_bwd_dq_cuda(*args))
        (dk, dv), dkv_kernel = launched(lambda: flash_bwd_dkv_cuda(*args))
        torch.cuda.synchronize()
        ref = flash_bwd_plain(*args)
        tol = GRAD_TOL[dtype_name]
        row = {"dtype": dtype_name, "causal": causal, "bh": bh, "tq": tq,
               "tk": tk, "dh": dh, "tol": tol, "dq_kernel": dq_kernel,
               "dkv_kernel": dkv_kernel, "dq_err": _max_err(dq, ref[0]),
               "dk_err": _max_err(dk, ref[1]),
               "dv_err": _max_err(dv, ref[2])}
        check(all(bool(torch.isfinite(g.float()).all()) and
                  _within(g, r, **tol)
                  for g, r in zip((dq, dk, dv), ref)),
              f"K2/K3 disagree with their plain version: {row}")
        # an f32 output equal to the plain version's: the check must see
        # an error of 1e-4 there (bf16 outputs round alike to equal)
        zero = [n for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)
                if dtype_name == "float32" and row[f"{n}_err"] == 0.0
                and not _check_is_live(g, r, tol)]
        check(not zero, f"an exact reading of {zero} is not a live check: "
              f"{row}")
        emit({"phase": "k2k3", **row})
        return row

    rows = [checked(dtype_name, causal, bh, tq, tk, dh,
                    inputs(getattr(torch, dtype_name), bh, tq, tk, dh,
                           causal))
            for dtype_name, causal, bh, tq, tk, dh in cases]
    _wide_bwd_tf32_control(torch)

    # the training shapes, each checked as above and then timed: the
    # probe's (Dh 64) in both dtypes, then Dh 128 (bf16, the dim-1024
    # model's; f32 beside it), then at B*H 256 Dh 16, 80 and 96 (lm96's
    # shape) beside Dh 32, then the dim-2048 model's Dh 256 with 192, 320
    # and 512 beside it (B*H 128)
    timed = []
    for dtype_name, bh, dh in (("bfloat16", TRAIN_BH, TRAIN_DH),
                               ("float32", TRAIN_BH, TRAIN_DH),
                               ("bfloat16", DH128_BH, 128),
                               ("float32", DH128_BH, 128),
                               *((dtype, DH128_BH, dh)
                                 for dh in (16, 32, 80, 96)
                                 for dtype in ("bfloat16", "float32")),
                               *((dtype, DH256_BH, dh)
                                 for dh in (192, 256, *PAST_TIMED_HEAD_DIMS)
                                 for dtype in ("bfloat16", "float32"))):
        dtype = getattr(torch, dtype_name)
        args = inputs(dtype, bh, TRAIN_T, TRAIN_T, dh, True)
        rows.append(checked(dtype_name, True, bh, TRAIN_T, TRAIN_T, dh,
                            args))
        q, k, v, do = args[0], args[1], args[2], args[4]
        item = q.element_size()
        shape = (bh // 8, 8, TRAIN_T, dh)   # (B, H, T, Dh)
        qs, ks, vs = (x.detach().view(shape).requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        row = {"dtype": dtype_name, "bh": bh, "t": TRAIN_T,
               "dh": dh, "causal": True,
               "dq_kernel": rows[-1]["dq_kernel"],
               "dkv_kernel": rows[-1]["dkv_kernel"],
               "dq_ms": device_ms(lambda: flash_bwd_dq_cuda(*args)),
               "dkv_ms": device_ms(lambda: flash_bwd_dkv_cuda(*args)),
               "plain_ms": device_ms(lambda: flash_bwd_plain(*args)),
               # one call computes dQ, dK and dV: K2 and K3 together
               "library_bwd_ms": device_ms(lambda: torch.autograd.grad(
                   out, (qs, ks, vs), do.view(shape), retain_graph=True))}
        row["dq_bound_ms"], row["dq_bound_by"] = flash_bwd_bound(
            "dq", bh, TRAIN_T, dh, item)
        row["dkv_bound_ms"], row["dkv_bound_by"] = flash_bwd_bound(
            "dkv", bh, TRAIN_T, dh, item)
        for key in ("dq", "dkv"):
            row[f"{key}_tflops"] = flash_bwd_flops(
                key, bh, TRAIN_T, dh) / row[f"{key}_ms"] / 1e9
        emit({"phase": "k2k3_timed", **row})
        timed.append(row)
        del out, qs, ks, vs, args, q, k, v, do
    return rows, timed


def _leaves(variables):
    from distkeras_tpu_torch.utils.tree import tree_leaves
    return tree_leaves(variables["params"])


def device_events(prof):
    """The device's kernels and copies in ``prof``'s trace, as (start µs,
    end µs, name), read from kineto's own event list: ``prof.events()``
    builds a tree of every event first, which takes minutes for a few
    epochs of ResNet-50.  Read once a trace (seconds for two such epochs)
    and kept on ``prof``, with the seconds the read took
    (``prof.device_events_read_s``); not to be changed by the caller."""
    from torch.autograd import DeviceType
    if not hasattr(prof, "_device_events"):
        t0 = time.perf_counter()
        prof._device_events = [
            (e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()
            and not getattr(e, "is_hidden_event", lambda: False)()]
        prof.device_events_read_s = time.perf_counter() - t0
    return prof._device_events


def last_epoch_on_device(prof, epochs=2):
    """The last epoch of an ``epochs``-epoch ``train()`` traced by
    ``prof``, on the device's timeline: from the end of the previous
    epoch's loss readback to the end of its own — the trainer copies each
    epoch's losses into pinned memory, the run's only such copies — so
    the window the trainer's ``epoch_seconds`` measure with CUDA events.
    Returns (window µs, busy µs: the union of the device's intervals
    inside the window, {name: device µs inside the window})."""
    dev = device_events(prof)
    marks = sorted(end for _, end, name in dev if "Pinned" in name)
    check(len(marks) == epochs, f"expected {epochs} loss readbacks to "
          f"pinned memory in the trace, found {len(marks)}")
    lo, hi = marks[-2:]
    busy, reached, by_name = 0.0, lo, {}
    for start, end, name in sorted(
            (max(start, lo), min(end, hi), name) for start, end, name in dev):
        if end <= start:
            continue                  # outside the window
        busy += max(0.0, end - max(start, reached))
        reached = max(reached, end)
        by_name[name] = by_name.get(name, 0.0) + end - start
    check(busy > 0, "the profiler trace holds no device time in the epoch")
    return hi - lo, busy, by_name


def phase_train(torch):
    """``SingleTrainer`` on the probe model: (a) f32 flash vs dense
    parity, (b) the bf16 probe config with its launch counts, rates,
    memory and, from a profiled run's second epoch, its busy share."""
    import numpy as np
    from distkeras_tpu_torch import SingleTrainer
    from distkeras_tpu_torch.data import load_lm_corpus
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.obs import Registry
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda,
        reset_launches)
    kernels = {"flash_fwd": flash_fwd_cuda,
               "flash_bwd_dq": flash_bwd_dq_cuda,
               "flash_bwd_dkv": flash_bwd_dkv_cuda}
    # kernel names in the trace (the bf16 kernels' are
    # flash_{fwd,bwd_dq,bwd_dkv}_wgmma_kernel)
    names = {"flash_fwd": "flash_fwd_",
             "flash_bwd_dq": "flash_bwd_dq_",
             "flash_bwd_dkv": "flash_bwd_dkv_"}

    # (a) f32 flash vs dense: both trainers initialise from seed 0, so
    # both models start from the same weights.  Two epochs of 4 steps a
    # run; the second (warm) epoch's CUDA-event seconds give the step
    # time, and the pair runs in both orders (flash first, then dense
    # first), so neither twin pays the other's first use
    ds = load_lm_corpus(n_train=64, seq_len=LM["seq_len"],
                        vocab_size=LM["vocab_size"])[0]
    runs, f32_step_ms, f32_launches = {}, {"flash": [], "dense": []}, []
    f32_kernels = None
    for impl in ("flash", "dense", "dense", "flash"):
        t = SingleTrainer(zoo.gpt_lm(**{**LM, "attention_impl": impl}),
                          "sgd", SCE, batch_size=16, num_epoch=2,
                          learning_rate=0.1)
        # the f32 path (SingleTrainer's default dtype): counts set to 0
        # just before, read just after
        reset_launches()
        t.train(ds)
        if impl == "flash":
            f32_launches.append({n: k.launches for n, k in kernels.items()})
            f32_kernels = f32_kernels or kernel_launches()
        runs.setdefault(impl, (np.concatenate(t.get_history()),
                               _leaves(t.trained_variables)))
        rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
        f32_step_ms[impl].append(1e3 * rec["epoch_seconds"]
                                 / len(t.get_history()[-1]))
    (fl, fp), (dl, dp) = runs["flash"], runs["dense"]
    loss_rel = float(np.max(np.abs(fl - dl) / np.abs(dl)))
    param_err = max(float(np.max(np.abs(a - b))) for a, b in zip(fp, dp))
    check(fl.shape == (8,) and loss_rel <= 1e-4,
          f"f32 flash vs dense losses differ: {fl} vs {dl}")
    check(param_err <= 1e-4,
          f"f32 flash vs dense parameters differ by {param_err}")
    want = LM["num_blocks"] * len(fl)
    check(all(n == want for run in f32_launches for n in run.values()),
          f"f32 launches {f32_launches} != {want} each")
    f32_launches = f32_launches[0]

    # (b) the probe config, batch 64: the main path of this slice
    ds = load_lm_corpus(n_train=512, seq_len=LM["seq_len"],
                        vocab_size=LM["vocab_size"])[0]

    def trainer(epochs):
        t = SingleTrainer(zoo.gpt_lm(**LM), "sgd", SCE, batch_size=64,
                          learning_rate=0.1, compute_dtype="bfloat16",
                          num_epoch=epochs)
        t.tracer.registry = Registry()
        return t

    steps, epochs = 512 // 64, 3
    t = trainer(epochs)
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts set to 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    t.train(ds)
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    by_kernel = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    hist = t.get_averaged_history()
    retraces = t.tracer.registry.get("jit.retraces")
    retraces = 0 if retraces is None else int(retraces.value)
    check(all(bool(np.isfinite(h).all()) for h in t.get_history()),
          "a training loss is not finite")
    check(hist[-1] < hist[0], f"the loss did not fall: {hist}")
    check(retraces == 0, f"jit.retraces == {retraces}")
    want = LM["num_blocks"] * steps * epochs
    check(all(n == want for n in launches.values()),
          f"launches {launches} != {want} each")
    rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]

    # two more epochs under the profiler (their launches are not counted);
    # the second is read on the device's timeline
    def profiled():
        pt = trainer(2)
        pt.train(ds)
        return pt

    pt, prof = traced(torch, profiled, "train")
    profiled_epoch = None               # not measured
    if prof is not None:
        window_us, busy_us, by_name = last_epoch_on_device(prof)
        epoch_s = [r for r in pt.metrics.records
                   if r["event"] == "epoch"][-1]["epoch_seconds"]
        share = {n: sum(us for name, us in by_name.items()
                        if names[n] in name) / busy_us for n in kernels}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        profiled_epoch = {
            # the second epoch's window on the trace's device timeline,
            # and the trainer's own CUDA-event seconds for it
            "window_s": window_us / 1e6, "epoch_s": epoch_s,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / window_us,
            "kernel_share_of_device": share,
            "top_kernels": [{"name": name[:90], "device_ms": us / 1e3}
                            for name, us in top]}
    row = {"phase": "train", "model": LM,
           "parity_f32": {"losses_flash": fl.tolist(),
                          "losses_dense": dl.tolist(),
                          "loss_max_rel_err": loss_rel,
                          "param_max_abs_err": param_err,
                          # warm epochs, in run order: flash first,
                          # then dense first
                          "warm_step_ms_flash": f32_step_ms["flash"],
                          "warm_step_ms_dense": f32_step_ms["dense"],
                          "launches": f32_launches,
                          "kernel_launches": f32_kernels},
           "probe": {"batch_size": 64, "steps_per_epoch": steps,
                     "epochs": epochs, "compute_dtype": "bfloat16",
                     "optimizer": "sgd", "learning_rate": 0.1},
           "epoch_mean_loss": hist.tolist(), "wall_s": wall,
           "last_epoch_s": rec["epoch_seconds"],
           "samples_per_s": rec["samples_per_sec"],
           "tokens_per_s": rec["samples_per_sec"] * LM["seq_len"],
           "step_ms": 1e3 * rec["epoch_seconds"] / steps,
           "peak_memory_bytes": peak, "launches": launches,
           "kernel_launches": by_kernel, "jit_retraces": retraces,
           "profiled_epoch": profiled_epoch}
    emit(row)
    return row


def phase_lm128(torch):
    """``gpt_lm`` at ``mfu.py``'s ``--dim 1024`` (8 heads of Dh 128),
    bf16, trained by ``SingleTrainer``: 2 epochs of 8 steps at batch 32.
    The loss falls, and K1, K2 and K3 launch once per block per step."""
    import numpy as np
    from distkeras_tpu_torch import SingleTrainer
    from distkeras_tpu_torch.data import load_lm_corpus
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda,
        reset_launches)
    kernels = {"flash_fwd": flash_fwd_cuda,
               "flash_bwd_dq": flash_bwd_dq_cuda,
               "flash_bwd_dkv": flash_bwd_dkv_cuda}
    batch, steps, epochs = 32, 8, 2
    ds = load_lm_corpus(n_train=batch * steps, seq_len=LM128["seq_len"],
                        vocab_size=LM128["vocab_size"])[0]
    t = SingleTrainer(zoo.gpt_lm(**LM128), "sgd", SCE, batch_size=batch,
                      learning_rate=0.1, compute_dtype="bfloat16",
                      num_epoch=epochs)
    torch.cuda.reset_peak_memory_stats()
    # this path: counts set to 0 just before, read just after
    reset_launches()
    t.train(ds)
    launches = {n: k.launches for n, k in kernels.items()}
    by_kernel = kernel_launches()
    hist = t.get_averaged_history()
    check(all(bool(np.isfinite(h).all()) for h in t.get_history()),
          "a dim-1024 training loss is not finite")
    check(hist[-1] < hist[0], f"the dim-1024 loss did not fall: {hist}")
    want = LM128["num_blocks"] * steps * epochs
    check(all(n == want for n in launches.values()),
          f"dim-1024 launches {launches} != {want} each")
    rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
    row = {"phase": "lm128", "model": LM128, "head_dim": 128,
           "batch_size": batch, "steps_per_epoch": steps, "epochs": epochs,
           "compute_dtype": "bfloat16", "epoch_mean_loss": hist.tolist(),
           "step_ms": 1e3 * rec["epoch_seconds"] / steps,
           "samples_per_s": rec["samples_per_sec"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "kernel_launches": by_kernel}
    emit(row)
    return row


def phase_lm256(torch):
    """``gpt_lm`` at ``mfu.py``'s ``--dim 2048`` (8 heads of Dh 256: in
    bf16 K1, K2 and K3 on wgmma; in f32 all three as 3xTF32 on
    mma.sync): (a) bf16, trained by
    ``SingleTrainer``, 2 epochs of 4 steps at batch 16: the loss falls;
    (b) f32, flash and dense twins from seed 0, 2 steps at batch 16:
    per-step losses within rtol 1e-4 and every trained parameter within
    atol 1e-4; (c) f32, 4 greedy requests served by ``DecodeEngine``:
    every answer equals ``generate_tokens`` on the card.  K1, K2 and K3
    launch exactly once per block per step, each counted under the kernel
    of its route (so no training launch runs on a CUDA-core kernel), and
    K1 once per block per cold join."""
    import numpy as np
    from distkeras_tpu_torch import SingleTrainer
    from distkeras_tpu_torch.data import load_lm_corpus
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda,
        reset_launches)
    kernels = {"flash_fwd": flash_fwd_cuda,
               "flash_bwd_dq": flash_bwd_dq_cuda,
               "flash_bwd_dkv": flash_bwd_dkv_cuda}
    blocks = LM256["num_blocks"]

    def corpus(n):
        return load_lm_corpus(n_train=n, seq_len=LM256["seq_len"],
                              vocab_size=LM256["vocab_size"])[0]

    def counts():
        return {n: k.launches for n, k in kernels.items()}

    # (a) bf16: this path's counts set to 0 just before, read just after
    batch, steps, epochs = 16, 4, 2
    t = SingleTrainer(zoo.gpt_lm(**LM256), "sgd", SCE, batch_size=batch,
                      learning_rate=0.1, compute_dtype="bfloat16",
                      num_epoch=epochs)
    ds = corpus(batch * steps)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t.train(ds)
    launches = counts()
    by_kernel = kernel_launches()
    hist = t.get_averaged_history()
    check(all(bool(np.isfinite(h).all()) for h in t.get_history()),
          "a dim-2048 training loss is not finite")
    check(hist[-1] < hist[0], f"the dim-2048 loss did not fall: {hist}")
    want = blocks * steps * epochs
    check(all(n == want for n in launches.values()),
          f"dim-2048 launches {launches} != {want} each")
    check(by_kernel == [[k, "bfloat16", 256, want] for k in (
              "flash_bwd_dkv_wgmma_wide", "flash_bwd_dq_wgmma_wide",
              "flash_fwd_wgmma_wide")],
          f"dim-2048 bf16 launches by kernel {by_kernel}: K1-K3 not all "
          f"on wgmma")
    rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
    peak = torch.cuda.max_memory_allocated()
    del t

    # (b) f32, flash against dense: 2 steps of batch 16 from seed 0
    ds = corpus(2 * batch)
    runs, f32_launches, f32_kernels = {}, None, None
    for impl in ("flash", "dense"):
        t = SingleTrainer(zoo.gpt_lm(**{**LM256, "attention_impl": impl}),
                          "sgd", SCE, batch_size=batch, num_epoch=1,
                          learning_rate=0.1)
        reset_launches()
        t.train(ds)
        if impl == "flash":
            f32_launches = counts()
            f32_kernels = kernel_launches()
        runs[impl] = (np.concatenate(t.get_history()),
                      _leaves(t.trained_variables))
        del t
    (fl, fp), (dl, dp) = runs["flash"], runs["dense"]
    loss_rel = float(np.max(np.abs(fl - dl) / np.abs(dl)))
    param_err = max(float(np.max(np.abs(a - b))) for a, b in zip(fp, dp))
    check(fl.shape == (2,) and loss_rel <= 1e-4,
          f"dim-2048 f32 flash vs dense losses differ: {fl} vs {dl}")
    check(param_err <= 1e-4,
          f"dim-2048 f32 flash vs dense parameters differ by {param_err}")
    check(all(n == blocks * 2 for n in f32_launches.values()),
          f"dim-2048 f32 launches {f32_launches} != {blocks * 2} each")
    check(f32_kernels == [[k, "float32", 256, blocks * 2] for k in (
              "flash_bwd_dkv_f32_wide", "flash_bwd_dq_f32_wide",
              "flash_fwd_f32_wide")],
          f"dim-2048 f32 launches by kernel {f32_kernels}: K1-K3 not all "
          f"on 3xTF32")
    del runs, fp, dp

    # (c) f32 serving: 4 greedy requests, the first 4 of PROMPT_LENS
    model = zoo.gpt_lm(**LM256).init(seed=0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, LM256["vocab_size"], size=n)
               for n in PROMPT_LENS[:4]]
    registry, reqs, wall, _, served, served_kernels = serve_traffic(
        model, prompts)
    mismatches = _answers_match(torch, model, prompts,
                                [r.result() for r in reqs])
    joins = int(registry.snapshot()["serve.joins"]["value"])
    check(joins == len(prompts) and served == blocks * joins,
          f"dim-2048 flash_fwd launches {served} != {blocks} x {joins} "
          f"joins")
    row = {"phase": "lm256", "model": LM256, "head_dim": 256,
           "train": {"batch_size": batch, "steps_per_epoch": steps,
                     "epochs": epochs, "compute_dtype": "bfloat16",
                     "epoch_mean_loss": hist.tolist(),
                     "step_ms": 1e3 * rec["epoch_seconds"] / steps,
                     "samples_per_s": rec["samples_per_sec"],
                     "peak_memory_bytes": peak, "launches": launches,
                     "kernel_launches": by_kernel},
           "parity_f32": {"losses_flash": fl.tolist(),
                          "losses_dense": dl.tolist(),
                          "loss_max_rel_err": loss_rel,
                          "param_max_abs_err": param_err,
                          "launches": f32_launches,
                          "kernel_launches": f32_kernels},
           "serve": {"requests": len(reqs), "joins": joins,
                     "launches": served, "kernel_launches": served_kernels,
                     "wall_s": wall,
                     "mismatches": mismatches}}
    emit(row)
    return row


def phase_lm96(torch):
    """``gpt_lm`` at dim 768 (8 heads of Dh 96), the bf16 K1, K2 and K3 on
    wgmma reading the caller's rows unpadded: (a) bf16, trained by
    ``SingleTrainer``, 2 epochs of 8 steps at batch 32: the loss falls,
    K1, K2 and K3 launch exactly once per block per step, each counted
    at Dh 96 under ``flash_fwd`` / ``flash_bwd_dq`` / ``flash_bwd_dkv``;
    its step ms, samples/s and peak memory; (b) the same trainer at batch
    32 for 2 epochs of 1 step under the profiler: in the warm step's
    window every flash kernel is a wgmma one, and no operator of the run
    pads (``aten::constant_pad_nd``) or touches a tensor of the padded
    (B*H, T, 128) shape the wrappers used to copy into, the kernels the
    device ran around each flash kernel listed; (c) f32, flash and dense
    twins from seed 0, 2 steps at batch 16: per-step losses within rtol
    1e-4 and every trained parameter within atol 1e-4."""
    import numpy as np
    from torch.profiler import ProfilerActivity
    from distkeras_tpu_torch import SingleTrainer
    from distkeras_tpu_torch.data import load_lm_corpus
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.flash_attention import (
        HEAD_DIMS, flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda,
        reset_launches)
    kernels = {"flash_fwd": flash_fwd_cuda,
               "flash_bwd_dq": flash_bwd_dq_cuda,
               "flash_bwd_dkv": flash_bwd_dkv_cuda}
    blocks, seq = LM96["num_blocks"], LM96["seq_len"]
    dh = LM96["dim"] // LM96["num_heads"]

    def corpus(n):
        return load_lm_corpus(n_train=n, seq_len=seq,
                              vocab_size=LM96["vocab_size"])[0]

    def bf16_trainer(batch, epochs):
        return SingleTrainer(zoo.gpt_lm(**LM96), "sgd", SCE,
                             batch_size=batch, learning_rate=0.1,
                             compute_dtype="bfloat16", num_epoch=epochs)

    # (a) bf16: this path's counts set to 0 just before, read just after
    batch, steps, epochs = 32, 8, 2
    t = bf16_trainer(batch, epochs)
    ds = corpus(batch * steps)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t.train(ds)
    launches = {n: k.launches for n, k in kernels.items()}
    by_kernel = kernel_launches()
    hist = t.get_averaged_history()
    check(all(bool(np.isfinite(h).all()) for h in t.get_history()),
          "a dim-768 training loss is not finite")
    check(hist[-1] < hist[0], f"the dim-768 loss did not fall: {hist}")
    want = blocks * steps * epochs
    check(by_kernel == [[k, "bfloat16", dh, want] for k in (
              "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd")],
          f"dim-768 bf16 launches by kernel {by_kernel}: K1-K3 not "
          f"{want} each on wgmma at Dh {dh}")
    rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
    peak = torch.cuda.max_memory_allocated()
    del t

    # (b) a warm step under the profiler: 2 epochs of 1 step, the second
    # read between the epochs' loss readbacks to pinned memory
    _, prof = traced(
        torch, lambda: bf16_trainer(batch, 2).train(corpus(batch)), "lm96",
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        record_shapes=True)
    check(prof is not None, "lm96: the profiler traces hold no device time")
    dev = sorted(device_events(prof))
    marks = sorted(end for _, end, name in dev if "Pinned" in name)
    check(len(marks) == 2, f"lm96: {len(marks)} loss readbacks in the "
          f"profiled run, expected 2")
    step = [name for start, end, name in dev
            if marks[0] <= start and end <= marks[1]]
    flash = [i for i, name in enumerate(step) if "flash_" in name]
    check(len(flash) == 3 * blocks
          and all("_wgmma_kernel" in step[i] for i in flash),
          f"lm96: the warm step ran {[step[i] for i in flash]}, expected "
          f"{blocks} wgmma launches each of K1, K2 and K3")
    # the (B*H, T, Dh) shape the wrappers padded q, k, v, dO and the
    # outputs to before the bf16 kernels read Dh 96 unpadded
    padded = [batch * LM96["num_heads"], seq,
              next(w for w in HEAD_DIMS if dh <= w)]
    copies = sorted({(a.key, str(a.input_shapes))
                     for a in prof.key_averages(group_by_input_shape=True)
                     if a.key in ("aten::constant_pad_nd", "aten::pad")
                     or any(list(sh) == padded
                            for sh in (a.input_shapes or []))})
    check(not copies, f"lm96: the profiled run padded: {copies}")
    around = [[step[i - 1][:60] if i else None, step[i][:60],
               step[i + 1][:60] if i + 1 < len(step) else None]
              for i in flash]
    del prof

    # (c) f32, flash against dense: 2 steps of batch 16 from seed 0
    f32_batch = 16
    ds = corpus(2 * f32_batch)
    runs, f32_launches = {}, None
    for impl in ("flash", "dense"):
        t = SingleTrainer(zoo.gpt_lm(**{**LM96, "attention_impl": impl}),
                          "sgd", SCE, batch_size=f32_batch, num_epoch=1,
                          learning_rate=0.1)
        reset_launches()
        t.train(ds)
        if impl == "flash":
            f32_launches = kernel_launches()
        runs[impl] = (np.concatenate(t.get_history()),
                      _leaves(t.trained_variables))
        del t
    (fl, fp), (dl, dp) = runs["flash"], runs["dense"]
    loss_rel = float(np.max(np.abs(fl - dl) / np.abs(dl)))
    param_err = max(float(np.max(np.abs(a - b))) for a, b in zip(fp, dp))
    check(fl.shape == (2,) and loss_rel <= 1e-4,
          f"dim-768 f32 flash vs dense losses differ: {fl} vs {dl}")
    check(param_err <= 1e-4,
          f"dim-768 f32 flash vs dense parameters differ by {param_err}")
    check(sorted(n for *_, n in f32_launches) == [blocks * 2] * 3
          and all(d == "float32" and h == dh for _, d, h, _ in f32_launches),
          f"dim-768 f32 launches {f32_launches} != {blocks * 2} each")
    row = {"phase": "lm96", "model": LM96, "head_dim": dh,
           "train": {"batch_size": batch, "steps_per_epoch": steps,
                     "epochs": epochs, "compute_dtype": "bfloat16",
                     "epoch_mean_loss": hist.tolist(),
                     "step_ms": 1e3 * rec["epoch_seconds"] / steps,
                     "samples_per_s": rec["samples_per_sec"],
                     "peak_memory_bytes": peak, "launches": launches,
                     "kernel_launches": by_kernel},
           "profiled_step": {"device_kernels": len(step),
                             "flash_kernels_and_neighbours": around,
                             "pad_or_padded_ops": copies},
           "parity_f32": {"batch_size": f32_batch,
                          "losses_flash": fl.tolist(),
                          "losses_dense": dl.tolist(),
                          "loss_max_rel_err": loss_rel,
                          "param_max_abs_err": param_err,
                          "kernel_launches": f32_launches}}
    emit(row)
    return row


def _resnet20_f32_run(torch, device, dtype=None):
    """ResNet-20 of the bench's width from seed 0 in f32 (float64 with
    ``dtype``) on ``device``: (eval forward of 16 bench images, the losses
    of 2 SGD steps at the bench's lr 0.1 and batch 32, the trained
    parameters and state as float64 leaves)."""
    import numpy as np
    from distkeras_tpu_torch import bench
    from distkeras_tpu_torch.data import Dataset
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.utils.tree import tree_leaves
    data = bench.resnet20_data(64)
    if dtype is not None:
        data = Dataset({"features": data["features"].astype(np.float64),
                        "label": data["label"]})
    model = zoo.resnet20(width=bench.WIDTH).init(0, device=device).to(
        dtype or torch.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(data["features"][:16]).to(device))
    t = bench.resnet20_trainer(1, device=device, batch_size=32,
                               compute_dtype=None)
    if dtype is not None:
        build = t.model.init
        t.model.init = lambda seed=0, device=None: build(
            seed, device=device).to(dtype)
    t.train(data)
    return (out.cpu().double().numpy(), np.concatenate(t.get_history()),
            [np.asarray(a, np.float64) for a in tree_leaves(
                t.trained_variables)])


def f32_parity(torch):
    """The f32 card-vs-CPU check of ResNet-20: the card's run (TF32 off,
    cuDNN deterministic) against the port's on the CPU, beside a float64
    witness (the port on the CPU in float64) and a control on the card
    with TF32 on.  Returns the readings: per run, the eval forward's and
    the losses' largest abs errors and ``step_rel``, the largest over
    leaves of ||Δ − Δ_ref|| / ||Δ_ref|| of the 2-step change Δ of the
    parameters and state."""
    import numpy as np
    from distkeras_tpu_torch import bench
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.utils import to_numpy_variables
    from distkeras_tpu_torch.utils.tree import tree_leaves
    init = [np.asarray(a, np.float64) for a in tree_leaves(
        to_numpy_variables(zoo.resnet20(width=bench.WIDTH).init(
            0, device="cpu")))]
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        runs = {"cpu": _resnet20_f32_run(torch, "cpu"),
                "float64": _resnet20_f32_run(torch, "cpu", torch.float64),
                "cuda": _resnet20_f32_run(torch, "cuda")}
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        runs["cuda_tf32"] = _resnet20_f32_run(torch, "cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = prev

    def against(name, ref):
        (fa, la, va), (fb, lb, vb) = runs[name], runs[ref]
        return {"forward_max_abs_err": float(np.max(np.abs(fa - fb))),
                "loss_max_abs_err": float(np.max(np.abs(la - lb))),
                "step_rel": max(float(np.linalg.norm(a - b) /
                                      np.linalg.norm(b - i))
                                for a, b, i in zip(va, vb, init))}
    return {"cuda_vs_cpu": against("cuda", "cpu"),
            "cuda_tf32_vs_cpu": against("cuda_tf32", "cpu"),
            "cuda_vs_float64": against("cuda", "float64"),
            "cpu_vs_float64": against("cpu", "float64"),
            "losses_cuda": runs["cuda"][1].tolist()}


def f32_parity_ok(reading) -> bool:
    """The card's f32 ResNet-20 agrees with the CPU's: eval forward and
    losses within atol 1e-4, every leaf's 2-step change within
    ``F32_STEP_REL`` of the CPU's."""
    return (reading["forward_max_abs_err"] <= 1e-4
            and reading["loss_max_abs_err"] <= 1e-4
            and reading["step_rel"] <= F32_STEP_REL)


def phase_conv(torch):
    """The headline bench's ResNet-20 (``distkeras_tpu_torch.bench``'s
    data and trainer: width 16, batch 1024, sgd lr 0.1, bf16) on the card:
    samples/s, step ms, peak memory and, from a profiled warm two-epoch
    run, the busy share.  Checks: the loss falls, the BatchNorm state is
    finite and has moved, and ``f32_parity``: the card's f32 run agrees
    with the CPU's (``f32_parity_ok``) and the TF32 control does not."""
    import numpy as np
    from distkeras_tpu_torch import bench
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.utils import to_numpy_variables
    from distkeras_tpu_torch.utils.tree import tree_leaves
    steps = CONV["steps"]
    ds = bench.resnet20_data(bench.BATCH * steps)

    t = bench.resnet20_trainer(CONV["epochs"])
    init_state = tree_leaves(to_numpy_variables(
        zoo.resnet20(width=bench.WIDTH).init(t.seed, device="cpu"))[
        "state"])
    torch.cuda.reset_peak_memory_stats()
    t.train(ds)
    peak = torch.cuda.max_memory_allocated()
    hist = t.get_averaged_history()
    state = tree_leaves(t.trained_variables["state"])
    check(all(bool(np.isfinite(h).all()) for h in t.get_history()),
          "a ResNet-20 training loss is not finite")
    check(hist[-1] < hist[0], f"the ResNet-20 loss did not fall: {hist}")
    check(all(bool(np.isfinite(s).all()) for s in state),
          "the BatchNorm state is not finite")
    moved = sum(not np.allclose(a, b) for a, b in zip(state, init_state))
    check(moved == len(state), f"only {moved} of {len(state)} BatchNorm "
          f"state leaves moved")
    rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]

    # a profiled run of 2 epochs, warm (the run above built every cuDNN
    # and cuBLAS handle): busy share = the union of the device's kernel
    # intervals (host-to-device copies of the data and weights, made
    # before the first epoch, left out) over the trainer's CUDA-event
    # seconds of both epochs
    def profiled():
        pt = bench.resnet20_trainer(2)
        pt.train(ds)
        return pt

    pt, prof = traced(torch, profiled, "conv")
    profiled_run = None                 # not measured
    if prof is not None:
        dev = sorted(e for e in device_events(prof) if "HtoD" not in e[2])
        busy_us, reached, by_name = 0.0, 0.0, {}
        for start, end, name in dev:
            busy_us += max(0.0, end - max(start, reached))
            reached = max(reached, end)
            by_name[name] = by_name.get(name, 0.0) + end - start
        window_us = 1e6 * sum(r["epoch_seconds"] for r in pt.metrics.records
                              if r["event"] == "epoch")
        check(busy_us > 0, "the conv profile holds no device time")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        profiled_run = {
            "epochs": 2, "epoch_seconds": window_us / 1e6,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / window_us,
            "top_kernels": [{"name": n[:90], "device_ms": us / 1e3}
                            for n, us in top]}

    parity = f32_parity(torch)
    check(f32_parity_ok(parity["cuda_vs_cpu"]),
          f"f32 ResNet-20 on the card vs the CPU: {parity}")
    check(not f32_parity_ok(parity["cuda_tf32_vs_cpu"]),
          f"the TF32 control passed the f32 check, which then cannot "
          f"tell TF32 from f32: {parity}")
    row = {"phase": "conv", "model": f"resnet20(width={bench.WIDTH})",
           "batch_size": bench.BATCH, "steps_per_epoch": steps,
           "epochs": CONV["epochs"], "compute_dtype": "bfloat16",
           "optimizer": "sgd", "learning_rate": bench.LEARNING_RATE,
           "epoch_mean_loss": hist.tolist(),
           "samples_per_s": rec["samples_per_sec"],
           "step_ms": 1e3 * rec["epoch_seconds"] / steps,
           "peak_memory_bytes": peak,
           "bn_state_leaves_moved": moved,
           "profiled_run": profiled_run,
           "parity_f32": {"cudnn_deterministic": True,
                          "learning_rate": bench.LEARNING_RATE, "steps": 2,
                          "step_rel_limit": F32_STEP_REL, **parity}}
    emit(row)
    return row


def phase_models(torch):
    """The other BASELINE.json models on the card: the MNIST
    time-to-99% row (``distkeras_tpu_torch.bench``'s ``--mnist``), and
    one training step each of ``lstm_imdb``, ``resnet50(stem="conv7")``
    and ``resnet50(stem="s2d")`` at full width and a small batch, with
    finite losses."""
    import numpy as np
    from distkeras_tpu_torch import SingleTrainer, bench
    from distkeras_tpu_torch.data import load_imagenet_subset, load_imdb
    from distkeras_tpu_torch.models import zoo
    mnist = bench.mnist_row()
    check(mnist["reached"], f"MNIST did not reach 99%: {mnist['checks']}")
    emit({"phase": "mnist", **mnist})
    steps = {}
    for name, model, ds, loss, bs in (
            ("lstm_imdb", zoo.lstm_imdb(), load_imdb(n_train=64)[0],
             "binary_crossentropy", 64),
            ("resnet50_conv7", zoo.resnet50(stem="conv7"),
             load_imagenet_subset(n_train=16)[0], SCE, 16),
            ("resnet50_s2d", zoo.resnet50(stem="s2d"),
             load_imagenet_subset(n_train=16)[0], SCE, 16)):
        t = SingleTrainer(model, "sgd", loss, batch_size=bs,
                          learning_rate=0.01, compute_dtype="bfloat16")
        t.train(ds)
        losses = np.concatenate(t.get_history())
        check(losses.shape == (1,) and bool(np.isfinite(losses).all()),
              f"{name}: training loss {losses}")
        steps[name] = {"batch_size": bs, "loss": float(losses[0]),
                       "step_s": [r for r in t.metrics.records
                                  if r["event"] == "epoch"][-1][
                                      "epoch_seconds"]}
    row = {"phase": "models", "one_step": steps}
    emit(row)
    return mnist, row


def _dist_data(cfg):
    """A ``DIST_CONFIGS`` entry's training Dataset, one-hot labels added
    as the yaml runner adds them (``label_onehot``)."""
    from distkeras_tpu_torch import data
    from distkeras_tpu_torch.data.transformers import OneHotTransformer
    ds = getattr(data, cfg["dataset"])(**cfg["dataset_kwargs"])[0]
    if cfg["onehot"]:
        ds = OneHotTransformer(cfg["onehot"], "label",
                               "label_onehot").transform(ds)
    return ds


def _dist_trainer(name, cfg, **overrides):
    """``name`` (a trainer class of the port) over ``cfg`` (a yaml
    config as data) on the card, a distributed one at ``DIST_WORKERS``
    workers (``num_workers: auto``'s cap on one card)."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import zoo
    kw = {"loss": "categorical_crossentropy", "features_col": "features",
          "label_col": "label_onehot", **cfg["trainer_kwargs"]}
    kw.pop("num_workers", None)
    kw.update(overrides)
    if name != "SingleTrainer":
        kw["num_ensembles" if name == "EnsembleTrainer"
           else "num_workers"] = DIST_WORKERS
    model = getattr(zoo, cfg["model"])(**cfg["model_kwargs"])
    return getattr(dkt, name)(model, **kw)


def _edge_identities(torch, t, ds):
    """The rule at one window edge on the card's stacked tensors: worker
    k's model trains slice k of the local stack through one window, then
    the edge.  Each rule's closed form, computed in float64 from the
    trees just before the edge, must hold within 1e-6 of the largest
    |value| (ADAG: the center is the workers' mean and every worker holds
    it; DOWNPOUR and DynSGD: the center moves by Σ(l − c); EASGD: the
    elastic update of both; no rule: nothing moves); and every worker
    model's parameters must be its slice of the stack.  Returns the
    largest error."""
    from distkeras_tpu_torch.parallel.sync import tmap
    from distkeras_tpu_torch.utils.tree import tree_leaves
    engine = t._engine_cache[1]
    xs, ys, _ = t._stage_data(ds, t.communication_window)
    wx, wy = (torch.from_numpy(a[:, 0]).to(t.device) for a in (xs, ys))
    center, local = t.center, t.local
    engine.local_steps(local, engine.init_opt_state(), wx, wy)
    c0, l0 = (tmap(lambda x: x.double(), tr) for tr in (center, local))
    engine.edge(center, local)
    torch.cuda.synchronize()
    rule = engine.algo.name
    if rule == "adag":
        want_c = tmap(lambda l: l.mean(0), l0)
        want_l = tmap(lambda c, l: c.expand_as(l), want_c, l0)
    elif rule in ("downpour", "dynsgd"):
        want_c = tmap(lambda c, l: c + (l - c).sum(0), c0, l0)
        want_l = tmap(lambda c, l: c.expand_as(l), want_c, l0)
    elif rule == "easgd":
        a = engine.algo.alpha
        want_c = tmap(lambda c, l: c + (a * (l - c)).sum(0), c0, l0)
        want_l = tmap(lambda c, l: l - a * (l - c), c0, l0)
    else:
        want_c, want_l = c0, l0
    err = 0.0
    for got, want in zip(tree_leaves(center) + tree_leaves(local),
                         tree_leaves(want_c) + tree_leaves(want_l)):
        e = (got.double() - want).abs().max().item()
        check(e <= 1e-6 * max(want.abs().max().item(), 1.0),
              f"{rule}: the window edge breaks its rule by {e}")
        err = max(err, e)
    for k, worker in enumerate(engine.workers):
        for name, p in worker.named_parameters():
            check(p.data_ptr() == local["params"][name][k].data_ptr(),
                  f"{rule}: worker {k}'s {name} is not a view of the stack")
    return err


def _edge_ms(torch, t, reps=20):
    """The window edge alone on the trained trees: CUDA events around
    ``reps`` edges after 3 warm ones, ms per edge."""
    engine = t._engine_cache[1]
    for _ in range(3):
        engine.edge(t.center, t.local)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        engine.edge(t.center, t.local)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _windows_f64_reading(torch, name, cfg, ds, perturb=False, runs=None):
    """``name`` over ``cfg``'s first ``F64_WINDOWS`` windows on the card
    (each worker's first rows of ``ds``, in the order the full run reads
    them; the same initial weights and generator states) in f32 against
    the same windows in float64, cuDNN deterministic and TF32 off.
    Returns the losses' errors and ``center_rel`` (see ``F64_CENTER_REL``)
    beside the runs.  ``perturb``: the live control — the f32 center's
    most-moving leaf moved along its float64 change by 3 x
    ``F64_CENTER_REL`` of the whole change's norm, which must fail."""
    import numpy as np
    from distkeras_tpu_torch.data import Dataset
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.utils import to_numpy_variables
    from distkeras_tpu_torch.utils.tree import tree_leaves
    kw = cfg["trainer_kwargs"]
    per = ds.num_rows // DIST_WORKERS
    take = F64_WINDOWS * kw["communication_window"] * kw["batch_size"]
    idx = np.concatenate([np.arange(k * per, k * per + take)
                          for k in range(DIST_WORKERS)])
    if runs is None:
        runs = {}
        prev = (torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            for key, dtype in (("float32", None),
                               ("float64", torch.float64)):
                cols = {c: ds[c][idx] for c in ("features", "label_onehot")}
                if dtype is not None:
                    cols["features"] = cols["features"].astype(np.float64)
                t = _dist_trainer(name, cfg, num_epoch=1)
                if dtype is not None:
                    build = t.model.init
                    t.model.init = lambda seed=0, device=None: build(
                        seed, device=device).to(dtype)
                t.train(Dataset(cols))
                runs[key] = (np.stack(t.get_history()[0]).astype(
                                 np.float64).reshape(DIST_WORKERS, -1),
                             [np.asarray(a, np.float64) for a in
                              tree_leaves(t.trained_variables)])
                del t
        finally:
            torch.backends.cudnn.deterministic, \
                torch.backends.cudnn.benchmark = prev
        runs["init"] = [np.asarray(a, np.float64) for a in tree_leaves(
            to_numpy_variables(getattr(zoo, cfg["model"])(
                **cfg["model_kwargs"]).init(0, device="cpu")))]
    (l32, c32), (l64, c64) = runs["float32"], runs["float64"]
    init = runs["init"]
    d64 = [b - i for b, i in zip(c64, init)]
    norm64 = float(np.sqrt(sum(np.sum(d * d) for d in d64)))
    if perturb:
        j = int(np.argmax([np.linalg.norm(d) for d in d64]))
        c32 = list(c32)
        c32[j] = c32[j] + 3 * F64_CENTER_REL * norm64 * d64[j] / \
            np.linalg.norm(d64[j])
    err = float(np.sqrt(sum(np.sum((a - b) ** 2)
                            for a, b in zip(c32, c64))))
    leaf_rel = [float(np.linalg.norm(a - b) / np.linalg.norm(d))
                for a, b, d in zip(c32, c64, d64) if np.linalg.norm(d) > 0]
    loss_err = np.abs(l32 - l64)
    return {"windows": F64_WINDOWS, "steps_per_worker": l32.shape[1],
            "first_step_loss_max_abs_err": float(loss_err[:, 0].max()),
            "loss_max_abs_err_by_step": loss_err.max(0).tolist(),
            "loss_max_abs_err": float(loss_err.max()),
            "center_rel": err / norm64,
            "leaf_rel_median": float(np.median(leaf_rel)),
            "losses_float64": l64.tolist(), "perturbed": perturb,
            "tol": {"first_step_loss": F64_FIRST_LOSS_TOL,
                    "loss": F64_LOSS_TOL, "center_rel": F64_CENTER_REL},
            "runs": runs}


def _windows_f64_ok(reading) -> bool:
    return (reading["first_step_loss_max_abs_err"] <= F64_FIRST_LOSS_TOL
            and reading["loss_max_abs_err"] <= F64_LOSS_TOL
            and reading["center_rel"] <= F64_CENTER_REL)


def _dist_parity_run(torch, name, ds, device, **kw):
    """(losses, trained leaves as float64, eval forward of the first 16
    rows) of ``name`` at ``DIST_WORKERS`` workers on ``device``."""
    import numpy as np
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.utils.tree import tree_leaves
    t = getattr(dkt, name)(device=device, num_workers=DIST_WORKERS, **kw)
    model = t.train(ds)
    with torch.no_grad():
        out = model(torch.from_numpy(ds["features"][:16]).to(t.device))
    return (np.concatenate([h.reshape(-1) for h in t.get_history()]),
            [np.asarray(a, np.float64) for a in tree_leaves(
                t.trained_variables)], out.double().cpu().numpy())


def phase_dist(torch):
    """The sync distributed trainers at ``DIST_WORKERS`` workers on the
    card: every ``DIST_RUNS`` entry (samples/s, ms a window, ms of the
    edge alone, peak memory, first and last epoch's mean loss; the loss
    falls — for ``NO_DIRECTION_CHECK``'s DynSGD, its first windows meet
    their float64 twin instead — and the edge holds its rule), ADAG over the flash LM in bf16
    (K1–K3 launched exactly W x steps x blocks times, and held at its
    shape), and two card-vs-CPU checks: the f32 toy ADAG within rtol 1e-5
    (plus 1e-6 of the largest |value|), and DOWNPOUR's BatchNorm model by
    ``f32_parity``'s relative measure, with a TF32-on control that must
    fail it.  Returns the rows, the parity rows and the flash run's
    ``kernel_launches``."""
    import numpy as np
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch import bench
    from distkeras_tpu_torch.data import load_lm_corpus
    from distkeras_tpu_torch.data.transformers import OneHotTransformer
    from distkeras_tpu_torch.models import Model, zoo
    from distkeras_tpu_torch.models.layers import Dense, Sequential
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_plain,
        flash_fwd_cuda, flash_fwd_plain, reset_launches)
    from distkeras_tpu_torch.utils import to_numpy_variables
    from distkeras_tpu_torch.utils.tree import tree_leaves
    rows = []
    for name, cfg_name in DIST_RUNS:
        cfg = DIST_CONFIGS[cfg_name]
        epochs = DIST_EPOCHS.get(name, cfg["trainer_kwargs"]["num_epoch"])
        ds = _dist_data(cfg)
        t = _dist_trainer(name, cfg, num_epoch=epochs)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        t.train(ds)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        hist = t.get_averaged_history()
        check(all(bool(np.isfinite(h).all()) for h in t.get_history()),
              f"{name}: a training loss is not finite")
        if name not in NO_DIRECTION_CHECK:
            check(hist[-1] < hist[0],
                  f"{name}: the loss did not fall: {hist}")
        recs = [r for r in t.metrics.records if r["event"] == "epoch"]
        steps = t.get_history()[-1].shape[1]
        n_windows = steps // t.communication_window
        row = {"phase": "dist", "trainer": name, "config": cfg_name,
               "model": cfg["model"], "workers": DIST_WORKERS,
               "window": t.communication_window,
               "batch_size": t.batch_size, "epochs": epochs,
               "epochs_in_config": cfg["trainer_kwargs"]["num_epoch"],
               "steps_per_worker_epoch": steps, "windows_per_epoch": n_windows,
               "first_epoch_mean_loss": float(hist[0]),
               "last_epoch_mean_loss": float(hist[-1]),
               "epoch_mean_loss": hist.tolist(),
               "samples_per_s": recs[-1]["samples_per_sec"],
               "epoch_s": recs[-1]["epoch_seconds"],
               "window_ms": 1e3 * recs[-1]["epoch_seconds"] / n_windows,
               "wall_s": wall, "peak_memory_bytes": peak,
               "edge_rule_max_err": _edge_identities(torch, t, ds),
               "edge_ms": _edge_ms(torch, t)}
        del t
        if name in NO_DIRECTION_CHECK:
            reading = _windows_f64_reading(torch, name, cfg, ds)
            perturbed = _windows_f64_reading(torch, name, cfg, ds,
                                             perturb=True,
                                             runs=reading["runs"])
            row["float64_twin"] = {k: v for k, v in reading.items()
                                   if k != "runs"}
            row["float64_twin_control"] = {k: v for k, v in
                                           perturbed.items() if k != "runs"}
            check(_windows_f64_ok(reading),
                  f"{name}: the f32 windows differ from their float64 "
                  f"twin: {row['float64_twin']}")
            check(not _windows_f64_ok(perturbed),
                  f"{name}: a perturbed center leaf passed the float64 "
                  f"check: {row['float64_twin_control']}")
        emit(row)
        rows.append(row)
        del ds

    # ADAG over the flash LM, bf16: the distributed path through K1-K3
    kernels = {"flash_fwd": flash_fwd_cuda,
               "flash_bwd_dq": flash_bwd_dq_cuda,
               "flash_bwd_dkv": flash_bwd_dkv_cuda}
    batch, window, steps, epochs = 8, 2, 4, 2
    ds = load_lm_corpus(n_train=DIST_WORKERS * batch * steps,
                        seq_len=LM["seq_len"],
                        vocab_size=LM["vocab_size"])[0]
    t = dkt.ADAG(zoo.gpt_lm(**LM), "sgd", SCE, num_workers=DIST_WORKERS,
                 batch_size=batch, communication_window=window,
                 learning_rate=0.1, compute_dtype="bfloat16",
                 num_epoch=epochs)
    torch.cuda.reset_peak_memory_stats()
    # this path: counts set to 0 just before, read just after
    reset_launches()
    t.train(ds)
    launches = {n: k.launches for n, k in kernels.items()}
    by_kernel = kernel_launches()
    hist = t.get_averaged_history()
    check(all(bool(np.isfinite(h).all()) for h in t.get_history()),
          "flash ADAG: a training loss is not finite")
    check(hist[-1] < hist[0], f"flash ADAG: the loss did not fall: {hist}")
    want = DIST_WORKERS * steps * epochs * LM["num_blocks"]
    check(all(n == want for n in launches.values()),
          f"flash ADAG launches {launches} != {want} each")
    recs = [r for r in t.metrics.records if r["event"] == "epoch"]
    # K1 and K2/K3 at this path's shape: B*H = 8 x 8 heads, T 512, Dh 64
    gen = torch.Generator(device="cuda").manual_seed(7)
    bh, dh = batch * LM["num_heads"], LM["dim"] // LM["num_heads"]
    q, k, v, do = (torch.randn((bh, LM["seq_len"], dh), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    scale = dh ** -0.5
    o_ref, lse_ref = flash_fwd_plain(q, k, v, True, scale)
    k1 = _k1_check(torch, (o_ref, lse_ref), flash_fwd_cuda(q, k, v, True,
                                                          scale),
                   "bfloat16", True, bh, LM["seq_len"], LM["seq_len"], dh)
    dvec = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, lse_ref, do, dvec, True, scale)
    got = (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
    ref = flash_bwd_plain(*args)
    check(all(_within(g, r, **GRAD_TOL["bfloat16"]) and
              bool(torch.isfinite(g.float()).all())
              for g, r in zip(got, ref)),
          "K2/K3 disagree with their plain version at the flash ADAG shape")
    flash = {"phase": "dist", "trainer": "ADAG", "config": "flash LM",
             "model": LM, "compute_dtype": "bfloat16",
             "workers": DIST_WORKERS, "window": window, "batch_size": batch,
             "epochs": epochs, "steps_per_worker_epoch": steps,
             "first_epoch_mean_loss": float(hist[0]),
             "last_epoch_mean_loss": float(hist[-1]),
             "samples_per_s": recs[-1]["samples_per_sec"],
             "tokens_per_s": recs[-1]["samples_per_sec"] * LM["seq_len"],
             "window_ms": 1e3 * recs[-1]["epoch_seconds"] / (steps // window),
             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
             "edge_rule_max_err": _edge_identities(torch, t, ds),
             "edge_ms": _edge_ms(torch, t), "launches": launches,
             "kernel_launches": by_kernel,
             "k1_max_abs_err": k1["max_abs_err"],
             "k2k3_max_abs_err": max(_max_err(g, r)
                                     for g, r in zip(got, ref))}
    emit(flash)
    rows.append(flash)
    del t, ds, q, k, v, do

    # f32 ADAG on the toy problem (tests/test_trainers_sync.py:18-30):
    # the card against the CPU, TF32 off
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2048, 10)).astype(np.float32)
    w = rng.normal(size=(10, 3)).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.normal(size=(2048, 3)), axis=-1)
    toy = OneHotTransformer(3, "label", "label_onehot").transform(
        dkt.Dataset({"features": x, "label": y}))

    def mlp():
        return Model(Sequential([Dense(32, "relu"), Dense(3, "softmax")]),
                     input_shape=(10,))
    toy_kw = dict(loss="categorical_crossentropy", label_col="label_onehot",
                  num_epoch=3, batch_size=32, learning_rate=0.05,
                  communication_window=4)
    runs = {dev: _dist_parity_run(torch, "ADAG", toy, dev,
                                  keras_model=mlp(), **toy_kw)
            for dev in ("cpu", "cuda")}
    toy_err = 0.0
    for a, b in zip([runs["cuda"][0]] + runs["cuda"][1],
                    [runs["cpu"][0]] + runs["cpu"][1]):
        bound = 1e-6 * np.abs(b).max() + 1e-5 * np.abs(b)
        check(bool(np.all(np.abs(a - b) <= bound)),
              f"f32 toy ADAG: the card differs from the CPU by "
              f"{np.abs(a - b).max()}")
        toy_err = max(toy_err, float(np.max(np.abs(a - b) / (
            1e-6 * np.abs(b).max() + 1e-5 * np.abs(b)))))

    # DOWNPOUR over ResNet-20 (width 16): BatchNorm state through the sum
    # rule.  One epoch of 2 windows of 2 steps at batch 8 per worker, at
    # ``DIST_BN_LR``
    bn_ds = bench.resnet20_data(DIST_WORKERS * 8 * 4)
    init = [np.asarray(a, np.float64) for a in tree_leaves(
        to_numpy_variables(zoo.resnet20(width=bench.WIDTH).init(
            0, device="cpu")))]
    bn_kw = dict(loss="categorical_crossentropy", num_epoch=1, batch_size=8,
                 communication_window=2, learning_rate=DIST_BN_LR)
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    bn = {}
    try:
        for key, dev in (("cpu", "cpu"), ("cuda", "cuda")):
            bn[key] = _dist_parity_run(
                torch, "DOWNPOUR", bn_ds, dev,
                keras_model=zoo.resnet20(width=bench.WIDTH), **bn_kw)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        bn["cuda_tf32"] = _dist_parity_run(
            torch, "DOWNPOUR", bn_ds, "cuda",
            keras_model=zoo.resnet20(width=bench.WIDTH), **bn_kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = prev

    def against(name):
        (la, va, fa), (lb, vb, fb) = bn[name], bn["cpu"]
        return {"forward_max_abs_err": float(np.max(np.abs(fa - fb))),
                "loss_max_abs_err": float(np.max(np.abs(la - lb))),
                "step_rel": max(float(np.linalg.norm(a - b) /
                                      np.linalg.norm(b - i))
                                for a, b, i in zip(va, vb, init))}
    bn_reading = {"cuda_vs_cpu": against("cuda"),
                  "cuda_tf32_vs_cpu": against("cuda_tf32")}
    check(f32_parity_ok(bn_reading["cuda_vs_cpu"]),
          f"f32 DOWNPOUR ResNet-20 on the card vs the CPU: {bn_reading}")
    check(not f32_parity_ok(bn_reading["cuda_tf32_vs_cpu"]),
          f"the TF32 control passed the DOWNPOUR f32 check: {bn_reading}")
    parity = {"phase": "dist_parity",
              "toy_adag": {"workers": DIST_WORKERS, "window": 4,
                           "epochs": 3, "tol": {"rtol": 1e-5,
                                                "atol_of_max": 1e-6},
                           "worst_share_of_bound": toy_err},
              "downpour_resnet20": {"width": bench.WIDTH, "batch_size": 8,
                                    "windows": 2, "window": 2,
                                    "learning_rate": DIST_BN_LR,
                                    "step_rel_limit": F32_STEP_REL,
                                    **bn_reading}}
    emit(parity)
    return rows, parity, flash["kernel_launches"]


def _reset_peak(torch) -> int:
    """Collect the earlier phases' garbage (trainers hold reference
    cycles, so their tensors outlive them until a collection), then
    restart the allocator's peak; returns the bytes still live, which
    the next peak reading includes."""
    import gc
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _launch_counts():
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda)
    return {"flash_fwd": flash_fwd_cuda.launches,
            "flash_bwd_dq": flash_bwd_dq_cuda.launches,
            "flash_bwd_dkv": flash_bwd_dkv_cuda.launches}


def _sum_launches(*rows):
    """[kernel, dtype, head dim, launches] rows of several paths, summed."""
    from collections import Counter
    total = Counter()
    for r in rows:
        for k, d, h, n in r:
            total[(k, d, h)] += n
    return [[k, d, h, n] for (k, d, h), n in sorted(total.items())]


def _same_bits(a, b) -> bool:
    import numpy as np
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y)
        for x, y in zip(a, b))


class _Builds:
    """Records the trainer of every ``config.build`` call inside it (the
    trainer ``config.run`` trained), to read its history and model."""

    def __enter__(self):
        from distkeras_tpu_torch import config
        self._real = real = config.build
        self.trainers = []

        def build(*args, **kw):
            out = real(*args, **kw)
            self.trainers.append(out[0])
            return out

        config.build = build
        return self

    def __exit__(self, *exc):
        from distkeras_tpu_torch import config
        config.build = self._real


#: the job's parameters against the in-process ``config.run``'s, in
#: largest abs difference over the leaves: bit-identical is expected
#: (the same seed, data, kernels and cuBLAS calls in a fresh process)
JOB_PARAM_TOL = 0.0


def phase_config(torch):
    """configs/bench_all.yaml through the port's config layer on the card:

    1. the flash LM (``YAML_LM``: dim 128, 4 heads of Dh 32, bf16, 4 epochs
       of 32 steps at batch 64) as configured, by ``config.run(cfg,
       repeat=2)``, then its ``quick`` variant (Dh 16, zero-padded to 32
       by the bf16 kernels): every loss finite, each call's falling, K1,
       K2 and K3 launched exactly once per block per step; the rows
       printed as ``config.main`` prints them;
    2. ``config.main([file, "--quick"])``: every config of the file built
       and trained on the card (the stream-from-disk ones spilled to
       shards and streamed), the table printed;
    3. the flash LM as a ``Job`` (``config.to_job``): ``Job.run()``
       spawns ``job_runner`` in a child process on the card, whose K1–K3
       launches fold into this process's counts (exactly steps x blocks,
       one worker); its trained parameters against the in-process run of
       part 1 (``JOB_PARAM_TOL``), its wall beside ``config.run``'s.

    Returns ``(rows, paths)``: paths are (name, launch rows) pairs of the
    ``kernels`` line."""
    import numpy as np
    from distkeras_tpu_torch import config
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    from distkeras_tpu_torch.utils.weights import to_numpy_variables
    base = {c.name: c for c in config.load_file(BENCH_YAML)}[YAML_LM]
    rows, paths, table = [], [], list(config.TABLE_HEADER)
    trained = None
    for variant, cfg in (("config", base), ("quick", base.with_quick())):
        kw, mk = cfg.trainer_kwargs, cfg.model_kwargs
        steps = cfg.dataset_kwargs["n_train"] // kw["batch_size"]
        live = _reset_peak(torch)
        # this path: counts set to 0 just before, read just after
        with _Builds() as builds:
            reset_launches()
            got = config.run(cfg, repeat=2)
            launches, by_kernel = _launch_counts(), kernel_launches()
        t = builds.trainers[0]
        hist = [float(np.mean(h)) for h in t.get_history()]
        check(all(bool(np.isfinite(h).all()) for h in t.get_history()),
              f"{cfg.name} ({variant}): a training loss is not finite")
        epochs = kw["num_epoch"]
        for call in (hist[:epochs], hist[epochs:]):
            if len(call) > 1:
                check(call[-1] < call[0], f"{cfg.name} ({variant}): the "
                      f"loss did not fall: {call}")
        want = 2 * mk["num_blocks"] * steps * epochs
        check(all(n == want for n in launches.values()),
              f"{cfg.name} ({variant}): launches {launches} != {want} each")
        if variant == "config":
            trained = to_numpy_variables(t.model)
            run_walls = got["wall_seconds"]
        rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
        row = {"phase": "config", "config": cfg.name, "variant": variant,
               "model": mk, "head_dim": mk["dim"] // mk["num_heads"],
               "steps_per_epoch": steps, "epochs": epochs, "calls": 2,
               "epoch_mean_loss": hist, "run": got,
               "step_ms": 1e3 * rec["epoch_seconds"] / steps,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "live_before_bytes": live,
               "launches": launches, "kernel_launches": by_kernel}
        emit(row)
        rows.append(row)
        paths.append((f"config_{variant}", by_kernel))
        table.append(config.format_row(got))
    for line in table:
        print(line, flush=True)

    t0 = time.perf_counter()
    reset_launches()
    check(config.main([BENCH_YAML, "--quick"]) == 0,
          "config.main --quick failed")
    by_kernel = kernel_launches()
    main_row = {"phase": "config", "variant": "main --quick",
                "configs": len(config.load_file(BENCH_YAML)),
                "wall_s": time.perf_counter() - t0,
                "launches": _launch_counts(), "kernel_launches": by_kernel}
    emit(main_row)
    rows.append(main_row)
    paths.append(("config_main_quick", by_kernel))

    job = config.to_job(base)
    kw, mk = base.trainer_kwargs, base.model_kwargs
    reset_launches()
    t0 = time.perf_counter()
    model = job.run(timeout=600)
    job_wall = time.perf_counter() - t0
    launches, by_kernel = _launch_counts(), kernel_launches()
    want = mk["num_blocks"] * (base.dataset_kwargs["n_train"]
                               // kw["batch_size"]) * kw["num_epoch"]
    check(all(n == want for n in launches.values()),
          f"job: launches {launches} != {want} each (folded from the "
          f"child)")
    check(model.device.type == "cuda", f"job: the model is on "
          f"{model.device}")
    got = to_numpy_variables(model)
    diffs = [float(np.max(np.abs(a.astype(np.float64) - b)))
             for a, b in zip(_leaves(got), _leaves(trained))]
    err = max(diffs)
    check(err <= JOB_PARAM_TOL, f"job: parameters {err} from the "
          f"in-process run")
    job_row = {"phase": "config", "variant": "job", "config": base.name,
               "child": "python -m distkeras_tpu_torch.job_runner",
               "job_wall_s": job_wall, "child_training_s":
               job.result_training_time,
               "config_run_two_calls_wall_s": run_walls,
               "max_abs_param_diff": err, "bit_identical": err == 0.0,
               "leaves": len(diffs), "epoch_mean_loss": [
                   float(np.mean(h)) for h in job.result_history],
               "launches": launches, "kernel_launches": by_kernel}
    emit(job_row)
    rows.append(job_row)
    paths.append(("job", by_kernel))
    return rows, paths


def _under_racecheck(fn, *args):
    """``fn(*args)`` under the port's ``racecheck.enabled()``: any
    unguarded concurrent write, lock-order cycle or write-after-publish
    it records fails the run."""
    from distkeras_tpu_torch.analysis import racecheck
    with racecheck.enabled() as violations:
        out = fn(*args)
        found = list(violations)
    check(not found, f"racecheck: {len(found)} violation(s) in "
          f"{fn.__name__}: " + "; ".join(
              f"{v['dict']}[{v['key']!r}] via {v['op']}" for v in found[:5]))
    return out


def _ckpt_dist(torch, tmp):
    """ADAG on ``DIST_CONFIGS``' ConvNet at 8 workers (its Dropout draws
    from the workers' generators): 2 epochs straight, twice (the control
    that the run itself repeats), against 1 epoch plus a resume to 2; the
    centers and the resumed epoch's losses must be bit-identical.  cuDNN
    runs its deterministic algorithms here."""
    import numpy as np
    from distkeras_tpu_torch.utils.tree import tree_leaves
    cfg = DIST_CONFIGS["ADAG ConvNet/CIFAR-10 (auto-w)"]
    ds = _dist_data(cfg)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            t = _dist_trainer("ADAG", cfg, num_epoch=2)
            t.train(ds)
            runs.append(t)
        first = _dist_trainer("ADAG", cfg, num_epoch=1, checkpoint_dir=tmp)
        first.train(ds)
        resumed = _dist_trainer("ADAG", cfg, num_epoch=2,
                                checkpoint_dir=tmp)
        resumed.train(ds, resume=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    leaves = [[np.asarray(a) for a in tree_leaves(t.trained_variables)]
              for t in (*runs, resumed)]
    repeat = _same_bits(leaves[0], leaves[1])
    same = _same_bits(leaves[2], leaves[0]) and _same_bits(
        resumed.get_history(), runs[0].get_history()[1:])
    err = max(float(np.max(np.abs(a.astype(np.float64) - b)))
              for a, b in zip(leaves[2], leaves[0]))
    check(repeat, "ADAG ConvNet: two straight runs differ (the run itself "
          "does not repeat)")
    check(same, f"ADAG ConvNet: 1 epoch + resume differs from 2 straight "
          f"epochs by {err}")
    return {"config": "ADAG ConvNet/CIFAR-10 (auto-w)",
            "workers": DIST_WORKERS, "epochs": 2,
            "straight_repeats_bit_identical": repeat,
            "resumed_bit_identical": same, "center_max_abs_diff": err}


def phase_ckpt(torch):
    """Checkpoints, resume and the model blob on the card, through K1-K3:
    the bf16 probe LM (``train``'s part (b): batch 64, 512 rows) trained
    3 epochs straight, twice, and 1 epoch with ``checkpoint_dir`` then
    resumed to 3; parameters and the resumed epochs' losses must equal
    the straight run's bit for bit, and K1, K2 and K3 launch once per
    block per step in every run.  The checkpoint's bytes, and its save
    and load on their own (device synchronised around each, 3 times).
    Then ``serialize()`` -> ``deserialize_model`` -> ``load_jax_variables``
    onto the card, serving 4 greedy requests through ``DecodeEngine``,
    whose answers must equal the trained model's ``generate_tokens``.
    Then ``_ckpt_dist`` (ADAG, 8 workers)."""
    import tempfile
    import numpy as np
    from distkeras_tpu_torch import SingleTrainer
    from distkeras_tpu_torch.data import load_lm_corpus
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    from distkeras_tpu_torch.utils import checkpoint, serde
    from distkeras_tpu_torch.utils.tree import tree_leaves
    from distkeras_tpu_torch.utils.weights import (load_jax_variables,
                                                   to_numpy_variables)
    batch, steps, epochs = 64, 512 // 64, 3
    ds = load_lm_corpus(n_train=batch * steps, seq_len=LM["seq_len"],
                        vocab_size=LM["vocab_size"])[0]

    def trainer(n, **kw):
        return SingleTrainer(zoo.gpt_lm(**LM), "sgd", SCE, batch_size=batch,
                             learning_rate=0.1, compute_dtype="bfloat16",
                             num_epoch=n, **kw)

    def run(t, **kw):
        # this path: counts set to 0 just before, read just after
        reset_launches()
        t.train(ds, **kw)
        launches = _launch_counts()
        want = LM["num_blocks"] * steps * len(t.get_history())
        check(all(n == want for n in launches.values()),
              f"ckpt: launches {launches} != {want} each")
        return launches, kernel_launches()

    def leaves(t):
        return [np.asarray(a) for a in tree_leaves(t.trained_variables)]

    straight = [trainer(epochs) for _ in range(2)]
    straight_launches = [run(t) for t in straight]
    with tempfile.TemporaryDirectory() as tmp:
        first, resumed = trainer(1, checkpoint_dir=tmp), \
            trainer(epochs, checkpoint_dir=tmp)
        first_launches = run(first)
        resumed_launches = run(resumed, resume=True)
        mgr = checkpoint.CheckpointManager(tmp)
        path = mgr.path(mgr.latest_step())
        ckpt_bytes = os.path.getsize(path)
        # the probe trains with plain sgd: an empty optimizer state
        tree = resumed._state_tree({})
        meta = {"epoch": epochs - 1}
        save_ms, load_ms = [], []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save_tree(os.path.join(tmp, f"timed-{i}.ckpt"), tree,
                                 meta)
            save_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            checkpoint.load_tree(path, tree)
            torch.cuda.synchronize()
            load_ms.append(1e3 * (time.perf_counter() - t0))
        dist = _ckpt_dist(torch, os.path.join(tmp, "adag"))
    repeat = _same_bits(leaves(straight[0]), leaves(straight[1]))
    same = _same_bits(leaves(resumed), leaves(straight[0]))
    losses_same = _same_bits(resumed.get_history(),
                             straight[0].get_history()[1:])
    check(repeat, "ckpt: two straight runs of the probe differ")
    check(same and losses_same, "ckpt: 1 epoch + resume differs from 3 "
          "straight epochs")

    # the model blob, deserialized onto the card, serving
    blob = resumed.serialize()
    model, variables = serde.deserialize_model(blob)
    model.init(0)
    load_jax_variables(model, variables)
    check(_same_bits(tree_leaves(to_numpy_variables(model)),
                     tree_leaves(resumed.trained_variables)),
          "ckpt: the deserialized model's weights differ from the trained")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, LM["vocab_size"], size=n)
               for n in PROMPT_LENS[:4]]
    registry, reqs, wall, _, served, served_kernels = serve_traffic(
        model, prompts)
    mismatches = _answers_match(torch, resumed.model, prompts,
                                [r.result() for r in reqs])
    joins = int(registry.snapshot()["serve.joins"]["value"])
    check(joins == len(prompts) and served == LM["num_blocks"] * joins,
          f"ckpt serve: flash_fwd launches {served} != "
          f"{LM['num_blocks']} x {joins} joins")
    row = {"phase": "ckpt", "model": LM, "batch_size": batch,
           "steps_per_epoch": steps, "epochs": epochs,
           "compute_dtype": "bfloat16", "optimizer": "sgd",
           "straight_repeats_bit_identical": repeat,
           "resumed_bit_identical": same,
           "resumed_losses_bit_identical": losses_same,
           "epoch_mean_loss": straight[0].get_averaged_history().tolist(),
           "checkpoint_bytes": ckpt_bytes,
           "parameters": sum(int(a.size) for a in leaves(resumed)),
           "save_ms": save_ms, "load_ms": load_ms,
           "launches": {"straight": straight_launches[0][0],
                        "first_epoch": first_launches[0],
                        "resumed": resumed_launches[0]},
           "kernel_launches": straight_launches[0][1],
           "kernel_launches_resumed": _sum_launches(first_launches[1],
                                                    resumed_launches[1]),
           "blob_bytes": len(blob),
           "serve": {"requests": len(reqs), "joins": joins,
                     "launches": served, "kernel_launches": served_kernels,
                     "wall_s": wall, "mismatches": mismatches},
           "dist": dist}
    emit(row)
    return row


def _stream_run(torch, cfg, source, epochs=None):
    """Train ``cfg`` from ``source`` (a ShardedFileDataset); returns the
    trainer, its wall seconds, its peak memory and the bytes live before
    it, and the stream counters' change over the run."""
    from distkeras_tpu_torch.data.streaming import DEPTH_BUCKETS
    from distkeras_tpu_torch.obs import default_registry
    reg = default_registry()
    names = ("stream.batches", "stream.stall_seconds",
             "stream.producer_leaks")
    before = {n: reg.counter(n).value for n in names}
    depth = reg.histogram("stream.prefetch_depth", DEPTH_BUCKETS)
    depth0 = depth.snapshot()
    over = {} if epochs is None else {"num_epoch": epochs}
    t = _dist_trainer(cfg["trainer"], cfg, **over)
    live = _reset_peak(torch)
    t0 = time.perf_counter()
    t.train(source)
    wall = time.perf_counter() - t0
    counters = {n: reg.counter(n).value - before[n] for n in names}
    depth1 = depth.snapshot()
    n = depth1["count"] - depth0["count"]
    counters["prefetch_depth_mean"] = \
        (depth1["sum"] - depth0["sum"]) / n if n else None
    return t, wall, (torch.cuda.max_memory_allocated(), live), counters


def phase_stream(torch):
    """configs/bench_all.yaml's two stream-from-disk configs
    (``STREAM_CONFIGS``, cut to ``STREAM_EPOCHS`` epochs), each reading
    shards written to a
    temporary directory from ``load_imagenet_subset``'s rows, once, under
    the profiler: samples/s of the last epoch, the stream's stall
    seconds, the prefetch queue's mean depth at a hand-over over the run,
    peak memory, and the busy share of its last epoch (and the time the
    trace takes to read); the loss falls.  Then one epoch of the
    SingleTrainer config from RAM and from disk on the same data order
    (cuDNN deterministic): parameters within rtol 2e-5, atol 2e-6
    (tests/test_streaming_data.py:114-131), bit-identical expected."""
    import shutil
    import tempfile
    import numpy as np
    from distkeras_tpu_torch.data import ShardedFileDataset
    rows = []
    tmp = tempfile.mkdtemp(prefix="dkt_stream_")
    try:
        for name, cfg in STREAM_CONFIGS.items():
            ds = _dist_data(cfg)
            t0 = time.perf_counter()
            src = ShardedFileDataset.write(ds, os.path.join(tmp, "full"),
                                           rows_per_shard=cfg["streaming"])
            spill_s = time.perf_counter() - t0
            # the busy share: the configured run under the profiler
            (t, wall, peak, counters), prof = traced(
                torch, lambda: _stream_run(torch, cfg, src, STREAM_EPOCHS),
                f"stream {name}")
            hist = t.get_averaged_history()
            check(all(bool(np.isfinite(h).all()) for h in t.get_history()),
                  f"{name}: a training loss is not finite")
            check(hist[-1] < hist[0], f"{name}: the loss did not fall: "
                  f"{hist}")
            check(counters["stream.producer_leaks"] == 0,
                  f"{name}: a prefetch thread outlived its join")
            rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
            profiled = None             # not measured
            if prof is not None:
                t0 = time.perf_counter()
                window_us, busy_us, _ = last_epoch_on_device(prof, len(hist))
                profiled = {"last_epoch_s": rec["epoch_seconds"],
                            "samples_per_s": rec["samples_per_sec"],
                            "window_s": window_us / 1e6,
                            "device_busy_share": busy_us / window_us,
                            "trace_read_s": prof.device_events_read_s
                            + time.perf_counter() - t0}
            del prof
            row = {"phase": "stream", "config": name,
                   "trainer": cfg["trainer"],
                   "workers": getattr(t, "num_workers", 1),
                   "rows_per_shard": cfg["streaming"],
                   "shards": len(src.shards), "spill_s": spill_s,
                   "epochs": len(hist), "epoch_mean_loss": hist.tolist(),
                   "wall_s": wall, "last_epoch_s": rec["epoch_seconds"],
                   "samples_per_s": rec["samples_per_sec"],
                   "stall_s": counters["stream.stall_seconds"],
                   "stall_share": counters["stream.stall_seconds"] / wall,
                   "batches": counters["stream.batches"],
                   "prefetch_depth_mean": counters["prefetch_depth_mean"],
                   "producer_leaks": counters["stream.producer_leaks"],
                   "peak_memory_bytes": peak[0],
                   "live_before_bytes": peak[1],
                   "profiled": profiled}
            if cfg["trainer"] == "SingleTrainer":
                row["ram_vs_disk"] = _ram_vs_disk(torch, cfg, ds, src)
            emit(row)
            rows.append(row)
            shutil.rmtree(os.path.join(tmp, "full"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def _ram_vs_disk(torch, cfg, ds, src):
    """One epoch of ``cfg`` from RAM and from disk, unshuffled (the same
    batches in the same order), cuDNN deterministic: the largest
    parameter difference, held to rtol 2e-5, atol 2e-6."""
    import numpy as np
    from distkeras_tpu_torch.utils.tree import tree_leaves
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for data in (ds, src):
            t = _dist_trainer(cfg["trainer"], cfg, num_epoch=1)
            t.train(data)
            out.append([np.asarray(a, np.float64)
                        for a in tree_leaves(t.trained_variables)])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ram, disk = out
    err = max(float(np.max(np.abs(a - b))) for a, b in zip(disk, ram))
    ok = all(bool(np.all(np.abs(a - b) <= 2e-6 + 2e-5 * np.abs(b)))
             for a, b in zip(disk, ram))
    check(ok, f"stream: RAM vs disk parameters differ by {err}")
    return {"max_abs_diff": err, "bit_identical": err == 0.0}


# ---------------------------------------------------------------------------
# async: the parameter server, its wire and mode="async"
# ---------------------------------------------------------------------------

#: the async rules on the probe LM: (trainer, its own arguments, learning
#: rate); each runs at its default communication window.  EAMSGD's
#: Nesterov momentum 0.9 multiplies its step tenfold, so it steps at a
#: fifth of the others' rate
ASYNC_RULES = (("DOWNPOUR", {}, 0.1), ("ADAG", {}, 0.1),
               ("DynSGD", {}, 0.1), ("AEASGD", {"rho": 1.0}, 0.1),
               ("EAMSGD", {"rho": 1.0}, 0.02))
#: thread workers and each one's batch on the probe LM
ASYNC_WORKERS, ASYNC_BATCH = 4, 8
#: the wire options, each on DOWNPOUR beside its plain run (``plain``:
#: the rules' DOWNPOUR run again, warm, as their baseline)
ASYNC_WIRE = (("plain", {}),
              ("codec_int8", {"comm_codec": "int8"}),
              ("codec_bf16", {"comm_codec": "bf16"}),
              ("codec_topk0.01", {"comm_codec": "topk0.01"}),
              ("down_int8", {"comm_down": "int8"}),
              ("shm", {"ps_shm": True}),
              ("pull_overlap", {"pull_overlap": True}))


def _span_registry(records):
    """A registry holding the run's worker spans as the tracers' own
    histograms (``span.<name>.seconds``, ``TIME_BUCKETS``): the
    ``ps.pull`` and ``ps.commit`` round trips every worker saw, thread
    or process (a worker process's spans are folded into the trainer's
    records); a sharded client's whole fan-out (``ps.shard.pull``,
    ``ps.shard.commit``) counts as its round trip."""
    from distkeras_tpu_torch.obs import TIME_BUCKETS, Registry
    reg = Registry()
    names = {"ps.pull": "ps.pull", "ps.commit": "ps.commit",
             "ps.shard.pull": "ps.pull", "ps.shard.commit": "ps.commit"}
    for r in records:
        if r["event"] == "span" and r["name"] in names:
            reg.histogram(f"span.{names[r['name']]}.seconds",
                          TIME_BUCKETS).observe(r["seconds"])
    return reg.snapshot()


def _quantiles(snap) -> dict:
    from distkeras_tpu_torch.obs import snapshot_quantile
    if snap is None or snap["count"] == 0:
        return {"p50": None, "p99": None, "mean": None, "count": 0}
    return {"p50": snapshot_quantile(snap, 0.5),
            "p99": snapshot_quantile(snap, 0.99),
            "mean": snap["sum"] / snap["count"], "count": snap["count"]}


def _accounting(snap) -> dict:
    """The PS's commit accounting; fails unless ``requests == applied +
    dropped + tombstoned``."""
    val = lambda n: int(snap.get(n, {}).get("value", 0))  # noqa: E731
    acc = {"requests": val("ps.commit_requests"),
           "applied": val("ps.commits"),
           "dropped": val("ps.commits_dropped"),
           "tombstoned": val("ps.commits_tombstoned"),
           "evictions": val("ps.evictions"), "respawns": val("ps.respawns"),
           "joins": val("ps.joins")}
    check(acc["requests"] == acc["applied"] + acc["dropped"]
          + acc["tombstoned"], f"PS accounting broken: {acc}")
    return acc


def _async_lm_trainer(name, lr=0.1, workers=None, batch=None, epochs=1,
                      **kw):
    """``name`` in async mode over the probe LM (bf16, sgd) at its default
    window; ``ASYNC_WORKERS`` workers of batch ``ASYNC_BATCH`` unless
    given."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import zoo
    return getattr(dkt, name)(zoo.gpt_lm(**LM), "sgd", SCE, mode="async",
                              num_workers=workers or ASYNC_WORKERS,
                              batch_size=batch or ASYNC_BATCH,
                              learning_rate=lr, compute_dtype="bfloat16",
                              num_epoch=epochs, **kw)


def _lm_rows(n):
    from distkeras_tpu_torch.data import load_lm_corpus
    return load_lm_corpus(n_train=n, seq_len=LM["seq_len"],
                          vocab_size=LM["vocab_size"])[0]


def _async_run(torch, t, ds, path, resume=False):
    """Train ``t`` (async) on ``ds``, its K1-K3 counts set to 0 just
    before and read just after (worker processes' launches folded in);
    returns the run's row: samples/s, windows and commits a worker,
    commit and pull round trips (``_span_registry``),
    bytes per commit and pull, staleness, the first and last window's
    mean loss and the PS accounting."""
    import numpy as np
    from distkeras_tpu_torch.obs import default_registry
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    before = default_registry().snapshot()
    reset_launches()
    t0 = time.perf_counter()
    t.train(ds, resume=resume)
    wall = time.perf_counter() - t0
    launches, by_kernel = _launch_counts(), kernel_launches()
    after = default_registry().snapshot()
    snap = t.ps_stats["registry"]
    acc = _accounting(snap)
    beats = sorted((r for r in t.metrics.records
                    if r["event"] == "heartbeat"), key=lambda r: r["ts"])
    by_window: dict = {}
    for r in beats:
        by_window.setdefault(r["window"], []).append(r["mean_loss"])
    first, last = min(by_window), max(by_window)
    hist = t.get_history()
    check(all(bool(np.isfinite(np.concatenate(
        [np.ravel(x) for x in (h if isinstance(h, list) else [h])])).all())
        for h in hist), f"{path}: a training loss is not finite")
    val = lambda n: snap.get(n, {}).get("value", 0)  # noqa: E731
    spans = _span_registry(t.metrics.records)
    samples = len(beats) * t.communication_window * t.batch_size
    row = {"phase": "async", "path": path, "trainer": type(t).__name__,
           "workers": t.num_workers, "placement": t.async_workers,
           "window": t.communication_window, "batch_size": t.batch_size,
           "windows_trained": len(beats),
           "commits_by_worker": {str(k): v for k, v in sorted(
               t.ps_stats["commits_by_worker"].items())},
           "wall_s": wall, "samples_per_s": samples / wall,
           "commit_rtt_s": _quantiles(spans.get("span.ps.commit.seconds")),
           "pull_rtt_s": _quantiles(spans.get("span.ps.pull.seconds")),
           "bytes_per_commit": val("ps.wire.bytes_up")
           / max(1, acc["requests"]),
           "bytes_per_pull": val("ps.wire.bytes_down")
           / max(1, val("ps.pulls")),
           "codec_bytes_raw": val("ps.codec.bytes_raw"),
           "codec_bytes_encoded": val("ps.codec.bytes_encoded"),
           "down_bytes_raw": val("ps.down.bytes_raw"),
           "down_bytes_encoded": val("ps.down.bytes_encoded"),
           "shm_bytes": after.get("net.bytes_shm", {}).get("value", 0)
           - before.get("net.bytes_shm", {}).get("value", 0),
           "staleness": _quantiles(snap.get("ps.staleness")),
           "first_window_mean_loss": float(np.mean(by_window[first])),
           "last_window_mean_loss": float(np.mean(by_window[last])),
           "accounting": acc, "launches": launches,
           "kernel_launches": by_kernel}
    return row


def _check_launches(row, windows, steps):
    """K1, K2 and K3 each launched exactly ``windows`` x ``steps`` x
    blocks times."""
    want = windows * steps * LM["num_blocks"]
    check(all(n == want for n in row["launches"].values()),
          f"{row['path']}: launches {row['launches']} != {want} each")


def _async_faults(torch):
    """Short DOWNPOUR runs on the probe LM (2 thread workers, window 5,
    batch 4, 2 windows each): a commit reset by ``SocketFaults``
    (evicted, respawned at its committed window, one window trained
    twice), a ``ThreadStall`` evicted past ``heartbeat_hard_s`` and
    respawned (its late commit tombstones), an ``add_worker`` join, and
    ``checkpoint_dir`` then ``train(resume=True)``: every worker resumes
    at its ``commits_by_worker`` window.  The accounting identity holds
    in each."""
    import tempfile
    import threading
    from distkeras_tpu_torch import chaos
    from distkeras_tpu_torch.ps import workers as workers_mod
    w, batch = 5, 4
    ds = _lm_rows(2 * batch * 2 * w)
    rows = []

    def wait(cond, what, timeout=120.0):
        end = time.monotonic() + timeout
        while not cond():
            check(time.monotonic() < end, f"timed out waiting for {what}")
            time.sleep(0.05)

    # a commit send reset: the worker dies, is respawned at its window
    t = _async_lm_trainer("DOWNPOUR", workers=2, batch=batch)
    with chaos.SocketFaults({"send:commit": [3]}) as faults:
        row = _async_run(torch, t, ds, "async_fault_reset")
    row["injected"] = faults.injected
    acc = row["accounting"]
    check(faults.injected == 1 and acc["evictions"] == 1
          and acc["respawns"] == 1 and acc["applied"] == 4,
          f"socket reset: {acc}, injected {faults.injected}")
    # the reset window trained, was lost, and trained again
    _check_launches(row, 5, w)
    rows.append(row)

    # a stalled thread: evicted, respawned, its late commit tombstoned
    t = _async_lm_trainer("DOWNPOUR", workers=2, batch=batch,
                          heartbeat_hard_s=5.0, startup_grace_s=300.0)
    out = {}
    with chaos.ThreadStall(workers_mod.PullCommitWorker, worker_id=1,
                           stall_after=1) as stall:
        th = threading.Thread(
            target=lambda: out.update(row=_async_run(
                torch, t, ds, "async_fault_stall")), daemon=True)
        th.start()
        check(stall.wait_stalled(300), "worker 1 never stalled")
        wait(lambda: t._supervisor is not None, "the supervisor")
        sup = t._supervisor
        wait(lambda: sup.ps.registry.counter("ps.evictions").value >= 1,
             "the stalled worker's eviction")
        stall.resume()
        th.join(300)
    check("row" in out, "the stalled run did not finish")
    acc = out["row"]["accounting"]
    check(acc["evictions"] == 1 and acc["respawns"] == 1
          and acc["tombstoned"] >= 1 and acc["applied"] == 4,
          f"thread stall: {acc}")
    rows.append(out["row"])

    # an elastic join into the live run
    t = _async_lm_trainer("DOWNPOUR", workers=2, batch=batch)
    out = {}
    with chaos.ThreadStall(workers_mod.PullCommitWorker, worker_id=0,
                           stall_after=1) as stall:
        th = threading.Thread(
            target=lambda: out.update(row=_async_run(
                torch, t, ds, "async_join")), daemon=True)
        th.start()
        check(stall.wait_stalled(300), "worker 0 never stalled")
        wait(lambda: t._supervisor is not None, "the supervisor")
        sup = t._supervisor
        joined = t.add_worker()
        wait(lambda: sup.ps.commits_by_worker.get(joined, 0) >= 1,
             "the joined worker's first commit")
        stall.resume()
        th.join(300)
    check("row" in out, "the join run did not finish")
    acc = out["row"]["accounting"]
    check(acc["joins"] == 1 and acc["applied"] == 6
          and out["row"]["commits_by_worker"] == {"0": 2, "1": 2, "2": 2},
          f"join: {acc}, {out['row']['commits_by_worker']}")
    _check_launches(out["row"], 6, w)
    rows.append(out["row"])

    # checkpoints of the center, then an exact per-worker resume
    with tempfile.TemporaryDirectory() as tmp:
        t = _async_lm_trainer("DOWNPOUR", workers=2, batch=batch,
                              checkpoint_dir=tmp)
        first = _async_run(torch, t, ds, "async_ckpt")
        t = _async_lm_trainer("DOWNPOUR", workers=2, batch=batch, epochs=2,
                              checkpoint_dir=tmp)
        resumed = _async_run(torch, t, ds, "async_resumed", resume=True)
    check(first["commits_by_worker"] == {"0": 2, "1": 2}
          and resumed["commits_by_worker"] == {"0": 4, "1": 4}
          and resumed["windows_trained"] == 4,
          f"resume: {first['commits_by_worker']} then "
          f"{resumed['commits_by_worker']}, "
          f"{resumed['windows_trained']} windows trained")
    _check_launches(first, 4, w)
    _check_launches(resumed, 4, w)
    rows += [first, resumed]
    for r in rows:
        emit(r)
    return rows


def _async_processes(torch):
    """DOWNPOUR with 2 process workers on configs/bench_all.yaml's flash
    LM (``YAML_LM``: Dh 32, bf16, batch 64): each child holds its
    own CUDA context and loads the kernel library the parent built; the
    children's launches fold into the parent's counts."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import zoo
    cfg = yaml_configs(YAML_LM)[YAML_LM]
    kw, mk = dict(cfg["trainer_kwargs"]), cfg["model_kwargs"]
    kw.pop("label_col")
    ds = _dist_data(cfg)
    t = dkt.DOWNPOUR(zoo.gpt_lm(**mk), "sgd", num_workers=2,
                     mode="async", async_workers="processes",
                     label_col="label", **kw)
    row = _async_run(torch, t, ds, "async_processes")
    steps = ds.num_rows // 2 // kw["batch_size"]
    windows = 2 * (steps // t.communication_window) * kw["num_epoch"]
    want = windows * t.communication_window * mk["num_blocks"]
    check(row["accounting"]["applied"] == windows,
          f"processes: {row['accounting']} for {windows} windows")
    check(all(n == want for n in row["launches"].values()),
          f"processes: launches {row['launches']} != {want} each")
    row["model"] = mk
    emit(row)
    return row


def phase_async(torch, dist_rows=()):
    """The async parameter server on the card (the PS on the host over
    loopback TCP, the workers' windows on the card):

    1. each rule (``ASYNC_RULES``) on the probe LM at full width, bf16,
       ``ASYNC_WORKERS`` thread workers of batch ``ASYNC_BATCH``, at its
       default window, 2 windows a worker: K1, K2 and K3 each launched
       exactly workers x windows x steps x blocks times, every window
       committed once, the accounting identity, the loss fell;
    2. the wire options (``ASYNC_WIRE``) on DOWNPOUR at the same size:
       bytes raw against encoded, commit round trips and samples/s
       beside the plain run's;
    3. ADAG ConvNet/CIFAR-10 (``DIST_CONFIGS``) at the ``dist`` phase's
       ``DIST_WORKERS`` workers in async mode, samples/s beside the sync
       figure;
    4. 2 process workers (``_async_processes``);
    5. faults, a join and a resume (``_async_faults``).

    Returns the rows."""
    import numpy as np
    rows = []
    for name, kw, lr in ASYNC_RULES:
        import distkeras_tpu_torch as dkt
        w = getattr(dkt, name)._default_window
        ds = _lm_rows(ASYNC_WORKERS * ASYNC_BATCH * 2 * w)
        t = _async_lm_trainer(name, lr=lr, **kw)
        row = _async_run(torch, t, ds, f"async_{name.lower()}")
        row["learning_rate"] = lr
        check(row["accounting"]["applied"] == ASYNC_WORKERS * 2
              and row["windows_trained"] == ASYNC_WORKERS * 2,
              f"{name}: {row['accounting']}")
        _check_launches(row, ASYNC_WORKERS * 2, w)
        check(row["last_window_mean_loss"] < row["first_window_mean_loss"],
              f"{name}: the loss did not fall")
        if name == "DynSGD":
            check(row["staleness"]["count"] == ASYNC_WORKERS * 2,
                  "DynSGD: staleness was not recorded per commit")
        emit(row)
        rows.append(row)
    plain = rows[0]
    w = plain["window"]
    for path, kw in ASYNC_WIRE:
        ds = _lm_rows(ASYNC_WORKERS * ASYNC_BATCH * 2 * w)
        ring_mb = None
        if kw.get("ps_shm"):
            # each client's two rings must hold a whole center (a message
            # that does not fit travels on TCP): size them to the plain
            # run's pull, within what /dev/shm has free
            ring_mb = int(plain["bytes_per_pull"] / 2 ** 20) + 8
            need = 2 * ASYNC_WORKERS * ring_mb * 2 ** 20
            st = os.statvfs("/dev/shm")
            check(st.f_bavail * st.f_frsize >= need,
                  f"shm: /dev/shm has {st.f_bavail * st.f_frsize} bytes "
                  f"free, the rings need {need}")
            os.environ["DKTPU_SHM_MB"] = str(ring_mb)
        try:
            row = _async_run(torch, _async_lm_trainer("DOWNPOUR", **kw), ds,
                             f"async_{path}")
        finally:
            os.environ.pop("DKTPU_SHM_MB", None)
        row["shm_ring_mb"] = ring_mb
        if path == "plain":
            plain = row
        row["option"] = kw
        row["plain_samples_per_s"] = plain["samples_per_s"]
        row["plain_commit_rtt_s"] = plain["commit_rtt_s"]
        check(row["accounting"]["applied"] == ASYNC_WORKERS * 2,
              f"{path}: {row['accounting']}")
        _check_launches(row, ASYNC_WORKERS * 2, w)
        check(row["last_window_mean_loss"] < row["first_window_mean_loss"],
              f"{path}: the loss did not fall")
        if "comm_codec" in kw:
            check(0 < row["codec_bytes_encoded"] < row["codec_bytes_raw"],
                  f"{path}: the codec saved no bytes")
        if "comm_down" in kw:
            check(0 < row["down_bytes_encoded"] < row["down_bytes_raw"],
                  f"{path}: the DOWN codec saved no bytes")
        if kw.get("ps_shm"):
            check(row["shm_bytes"] > 0, "shm: no bytes crossed the ring")
        emit(row)
        rows.append(row)
        if path == "plain":
            # the same run again, under the port's race checker
            rc = _under_racecheck(_async_run, torch,
                                  _async_lm_trainer("DOWNPOUR"), ds,
                                  "async_racecheck")
            check(rc["accounting"]["applied"] == ASYNC_WORKERS * 2,
                  f"racecheck: {rc['accounting']}")
            _check_launches(rc, ASYNC_WORKERS * 2, w)
            emit({"phase": "racecheck", "run": "async_downpour",
                  "workers": ASYNC_WORKERS, "violations": 0,
                  "seconds_with": rc["wall_s"],
                  "seconds_without": row["wall_s"]})
            rows.append(rc)

    cfg_name = "ADAG ConvNet/CIFAR-10 (auto-w)"
    cfg = DIST_CONFIGS[cfg_name]
    t = _dist_trainer("ADAG", cfg, mode="async")
    row = _async_run(torch, t, _dist_data(cfg), "async_adag_convnet")
    hist = t.get_averaged_history()
    check(hist[-1] < hist[0], f"async ADAG ConvNet: the loss did not fall: "
          f"{hist}")
    sync = [r for r in dist_rows if r["config"] == cfg_name
            and r["trainer"] == "ADAG"]
    row.update(config=cfg_name, epoch_mean_loss=hist.tolist(),
               sync_samples_per_s=sync[0]["samples_per_s"] if sync
               else None)
    emit(row)
    rows.append(row)

    rows.append(_async_processes(torch))
    rows += _async_faults(torch)
    check(all(bool(np.isfinite(r["last_window_mean_loss"])) for r in rows),
          "an async run's loss is not finite")
    return rows


# ---------------------------------------------------------------------------
# the sharded parameter server and the switch-MoE LM on the card
# ---------------------------------------------------------------------------

#: the async rules a sharded fleet runs (their ``ps/servers.py`` rules
#: are the ones a shard hosts), at ``SHARDS`` shards
SHARD_RULES = ("DOWNPOUR", "ADAG", "DynSGD")
SHARDS = 4
#: the switch-MoE probe: the probe LM with each FF block a switch-MoE of
#: 8 experts of the dense FF's width (``zoo._ff_block``)
MOE_LM = dict(LM, moe_experts=8)
#: the MoE runs' aux-loss weight
MOE_AUX_WEIGHT = 0.01


def _per_shard(row, t, windows):
    """Every shard applied each of the run's ``windows`` commits once and
    holds ``requests == applied + dropped + tombstoned``; the per-shard
    counts go into ``row``."""
    shards = []
    for i, snap in enumerate(t.ps_stats["shards"]):
        acc = _accounting(snap)
        check(acc["applied"] == windows,
              f"{row['path']}: shard {i} applied {acc['applied']} of "
              f"{windows} windows")
        shards.append({"accounting": acc,
                       "staleness": _quantiles(snap.get("ps.staleness")),
                       "bytes_up": snap.get("ps.wire.bytes_up", {}).get(
                           "value", 0)})
    row["shards"] = shards
    row["plan_digest"] = t.ps_stats["plan"]["digest"]
    row["shard_bytes"] = [s["bytes"] for s in t.ps_stats["plan"]["shards"]]


def _wait_workers_gone(timeout=120.0):
    """No async worker thread is left running (a stalled one resumed into
    a dead fleet exits on its failed pull, before any window)."""
    import threading
    end = time.monotonic() + timeout
    while any(th.name.startswith("worker-") and th.is_alive()
              for th in threading.enumerate()):
        check(time.monotonic() < end, "an async worker thread outlived "
              "its run")
        time.sleep(0.05)


def _read(path) -> str:
    with open(path) as f:
        return f.read()


def _shard_processes(torch):
    """``ProcessShardFleet``: 4 shard processes (``shard_main``, the card
    hidden from them) and 2 DOWNPOUR thread workers of the probe LM on the
    card, driven through the runner's own worker parts; K1-K3 launch
    exactly, every shard's accounting holds over the wire."""
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    from distkeras_tpu_torch.ps import runner
    from distkeras_tpu_torch.ps.shard import (ProcessShardFleet,
                                              ShardedPSClient)
    from distkeras_tpu_torch.ps.workers import PullCommitWorker
    from distkeras_tpu_torch.utils import to_numpy_variables
    workers = 2
    t = _async_lm_trainer("DOWNPOUR", workers=workers)
    w = t.communication_window
    ds = _lm_rows(workers * ASYNC_BATCH * 2 * w)
    xs, ys, _ = t._stage_data(ds, w)
    t.model.init(t.seed, device=t.device)
    center = to_numpy_variables(t.model)
    loss_fn, optimizer = t._resolve()
    t0 = time.perf_counter()
    with ProcessShardFleet(center, SHARDS, ps_class="delta",
                           num_workers=workers) as fleet:
        start_s = time.perf_counter() - t0
        # no shard process loaded JAX: jaxlib's extension would be mapped
        jax_mapped = [p.pid for p in fleet.procs
                      if "jaxlib" in _read(f"/proc/{p.pid}/maps")]
        check(not jax_mapped, f"shard_processes: processes {jax_mapped} "
              f"loaded jaxlib")
        ws = []
        reset_launches()
        t1 = time.perf_counter()
        for k in range(workers):
            window, variables, opt_state, gen = runner.worker_parts(
                runner._replica(t, center), loss_fn, optimizer,
                runner._worker_seed(t, k, 0), t.device, t.compute_dtype)
            wk = PullCommitWorker(k, window, variables, opt_state, gen,
                                  "127.0.0.1", list(fleet.ports), 1,
                                  device=t.device)
            wk.set_data(xs[k], ys[k])
            wk.start()
            ws.append(wk)
        for wk in ws:
            wk.join(600)
        wall = time.perf_counter() - t1
        launches, by_kernel = _launch_counts(), kernel_launches()
        for wk in ws:
            check(not wk.is_alive() and wk.error is None,
                  f"shard_processes: worker {wk.worker_id} failed: "
                  f"{wk.error!r}")
        with ShardedPSClient(fleet.addrs(), center, worker_id=99) as cl:
            stats = cl.stats()
    check(stats["commits_by_worker"] == {0: 2, 1: 2},
          f"shard_processes: commits {stats['commits_by_worker']}")
    accs = [_accounting(r["stats"]) for r in stats["shards"]]
    check(all(a["applied"] == workers * 2 for a in accs),
          f"shard_processes: per-shard accounting {accs}")
    want = workers * 2 * w * LM["num_blocks"]
    check(all(n == want for n in launches.values()),
          f"shard_processes: launches {launches} != {want} each")
    losses = [float(l.mean()) for wk in ws for _, l in wk.window_losses]
    row = {"phase": "shard", "path": "shard_processes", "shards": SHARDS,
           "workers": workers, "fleet_start_s": start_s, "wall_s": wall,
           "samples_per_s": workers * 2 * w * ASYNC_BATCH / wall,
           "accounting": accs, "window_mean_losses": losses,
           "launches": launches, "kernel_launches": by_kernel}
    emit(row)
    return row


def _shard_dead(torch):
    """A shard stopped mid-run: ``train()`` raises ``ShardFleetError``
    naming it (worker 0 stalled after its first window meanwhile)."""
    import threading
    from distkeras_tpu_torch import chaos
    from distkeras_tpu_torch.ps import workers as workers_mod
    from distkeras_tpu_torch.ps.shard import ShardFleetError
    t = _async_lm_trainer("DOWNPOUR", workers=2, ps_shards=SHARDS)
    ds = _lm_rows(2 * ASYNC_BATCH * 2 * t.communication_window)
    out = {}

    def run():
        try:
            t.train(ds)
        except BaseException as e:  # noqa: BLE001 — the phase's reading
            out["err"] = e

    t0 = time.perf_counter()
    with chaos.ThreadStall(workers_mod.PullCommitWorker, worker_id=0,
                           stall_after=1) as stall:
        th = threading.Thread(target=run, daemon=True)
        th.start()
        check(stall.wait_stalled(300), "shard_dead: worker 0 never stalled")
        end = time.monotonic() + 60
        while t._supervisor is None:
            check(time.monotonic() < end, "shard_dead: no supervisor")
            time.sleep(0.05)
        t_stop = time.perf_counter()
        t._supervisor.ps.servers[2].stop()   # shard 2 dies mid-run
        th.join(120)
        raised_s = time.perf_counter() - t_stop
    _wait_workers_gone()
    err = out.get("err")
    check(not th.is_alive() and isinstance(err, ShardFleetError)
          and f"shard 2/{SHARDS}" in str(err),
          f"shard_dead: the run did not raise ShardFleetError naming "
          f"shard 2: {err!r}")
    row = {"phase": "shard", "path": "shard_dead", "raised": repr(err),
           "raised_after_stop_s": raised_s,
           "wall_s": time.perf_counter() - t0}
    emit(row)
    return row


def phase_shard(torch, async_rows=()):
    """The sharded parameter server on the card (the shards on the host
    over loopback, the workers' windows on the card), the bf16 probe LM:

    1. DOWNPOUR, ADAG and DynSGD at ``SHARDS`` shards, ``ASYNC_WORKERS``
       thread workers of batch ``ASYNC_BATCH``, 2 windows each: K1-K3
       launch exactly, every shard applies each window once with its
       accounting identity, the loss falls, DynSGD records staleness per
       shard; samples/s and round trips beside ``async``'s single server;
    2. one worker at 2 shards against 1 shard: bit-identical centers;
    3. ``ProcessShardFleet`` (``_shard_processes``);
    4. a dead shard (``_shard_dead``);
    5. DOWNPOUR over the shards on the MoE LM: the plan holds the
       ``aux_loss`` leaves, its digest is ``ShardPlan``'s of the
       variables tree.
    Returns the rows."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    from distkeras_tpu_torch.ps.shard import ShardPlan
    from distkeras_tpu_torch.utils import to_numpy_variables
    from distkeras_tpu_torch.utils.tree import tree_leaves
    t_phase = time.perf_counter()
    rows = []
    single = {r["trainer"]: r for r in async_rows
              if r["path"] in ("async_downpour", "async_adag",
                               "async_dynsgd")}
    for name in SHARD_RULES:
        w = getattr(dkt, name)._default_window
        ds = _lm_rows(ASYNC_WORKERS * ASYNC_BATCH * 2 * w)
        t = _async_lm_trainer(name, ps_shards=SHARDS)
        row = _async_run(torch, t, ds, f"shard_{name.lower()}")
        row["phase"], row["ps_shards"] = "shard", SHARDS
        windows = ASYNC_WORKERS * 2
        check(row["windows_trained"] == windows
              and row["accounting"]["applied"] == SHARDS * windows,
              f"shard {name}: {row['accounting']}")
        _per_shard(row, t, windows)
        _check_launches(row, windows, w)
        check(row["last_window_mean_loss"] < row["first_window_mean_loss"],
              f"shard {name}: the loss did not fall")
        if name == "DynSGD":
            check(all(s["staleness"]["count"] == windows
                      for s in row["shards"]),
                  "shard DynSGD: staleness was not recorded per shard")
        ref = single.get(name)
        row["single_server"] = None if ref is None else {
            "samples_per_s": ref["samples_per_s"],
            "commit_rtt_s_p50": ref["commit_rtt_s"]["p50"],
            "pull_rtt_s_p50": ref["pull_rtt_s"]["p50"]}
        emit(row)
        rows.append(row)

    # one deterministic worker: 2 shards against 1, bit for bit
    ds = _lm_rows(ASYNC_BATCH * 2 * 5)
    reset_launches()
    runs = {}
    for shards in (1, 2):
        t = _async_lm_trainer("DOWNPOUR", workers=1, ps_shards=shards)
        t.train(ds)
        runs[shards] = _leaves(t.trained_variables) + tree_leaves(
            t.trained_variables["state"])
    launches, by_kernel = _launch_counts(), kernel_launches()
    check(_same_bits(runs[1], runs[2]),
          "shard_bit_identical: 2 shards differ from 1 server")
    want = 2 * 2 * 5 * LM["num_blocks"]
    check(all(n == want for n in launches.values()),
          f"shard_bit_identical: launches {launches} != {want} each")
    row = {"phase": "shard", "path": "shard_bit_identical",
           "leaves": len(runs[1]), "bit_identical": True,
           "launches": launches, "kernel_launches": by_kernel}
    emit(row)
    rows.append(row)

    rows.append(_shard_processes(torch))
    _shard_dead(torch)

    # DOWNPOUR over the shards on the MoE LM
    ds = _lm_rows(2 * ASYNC_BATCH * 2 * 5)
    t = dkt.DOWNPOUR(
        zoo.gpt_lm(**MOE_LM), "sgd", SCE, mode="async", num_workers=2,
        batch_size=ASYNC_BATCH, learning_rate=0.1, compute_dtype="bfloat16",
        aux_weight=MOE_AUX_WEIGHT, ps_shards=SHARDS)
    row = _async_run(torch, t, ds, "shard_moe")
    row["phase"], row["ps_shards"], row["model"] = "shard", SHARDS, MOE_LM
    _per_shard(row, t, 4)
    _check_launches(row, 4, 5)
    plan = t.ps_stats["plan"]
    aux_paths = sorted(p for s in plan["shards"] for p in s["paths"]
                       if p.endswith("/aux_loss"))
    check(len(aux_paths) == MOE_LM["num_blocks"],
          f"shard_moe: the plan's aux_loss leaves {aux_paths}")
    fresh = zoo.gpt_lm(**MOE_LM).init(t.seed)
    digest = ShardPlan.build(to_numpy_variables(fresh), SHARDS).digest
    check(plan["digest"] == digest,
          f"shard_moe: plan digest {plan['digest']} != {digest}")
    del fresh
    row["aux_leaves"] = aux_paths
    emit(row)
    rows.append(row)
    emit({"phase": "shard", "seconds": time.perf_counter() - t_phase})
    return rows


def _moe_f32_run(torch, device, batch, steps, tf32=False):
    """The MoE LM from seed 0 in f32 on ``device``: (eval logits of 2
    sequences at init, the losses of ``steps`` SGD steps at lr 0.1 with
    the aux weight, the trained leaves, the initial leaves, the launches
    counted by kernel)."""
    import numpy as np
    from distkeras_tpu_torch import SingleTrainer
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    from distkeras_tpu_torch.utils import to_numpy_variables
    from distkeras_tpu_torch.utils.tree import tree_leaves
    ds = _lm_rows(batch * steps)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        model = zoo.gpt_lm(**MOE_LM).init(0, device=device)
        init = [np.asarray(a, np.float64)
                for a in tree_leaves(to_numpy_variables(model))]
        x = torch.from_numpy(ds["features"][:2]).long().to(device)
        with torch.no_grad():
            logits = model(x).double().cpu().numpy()
        del model
        t = SingleTrainer(zoo.gpt_lm(**MOE_LM), "sgd", SCE,
                          batch_size=batch, num_epoch=1, learning_rate=0.1,
                          aux_weight=MOE_AUX_WEIGHT, device=device)
        reset_launches()
        t.train(ds)
        by_kernel = kernel_launches()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return (logits, np.concatenate(t.get_history()),
            [np.asarray(a, np.float64) for a in tree_leaves(
                t.trained_variables)], init, by_kernel)


def _moe_f32_reading(run, ref):
    import numpy as np
    (la, loss_a, va, init, _), (lb, loss_b, vb, _, _) = run, ref
    return {"forward_max_abs_err": float(np.max(np.abs(la - lb))),
            "loss_max_rel_err": float(np.max(np.abs(loss_a - loss_b)
                                             / np.abs(loss_b))),
            "param_max_abs_err": max(float(np.max(np.abs(a - b)))
                                     for a, b in zip(va, vb)),
            "step_rel": max(float(np.linalg.norm(a - b)
                                  / max(np.linalg.norm(b - i), 1e-30))
                            for a, b, i in zip(va, vb, init))}


def moe_f32_ok(reading) -> bool:
    """The card's f32 MoE LM agrees with the CPU's within the ``train``
    phase's f32 bounds (losses rtol 1e-4, every parameter atol 1e-4) and
    the ``conv`` phase's forward bound (atol 1e-4)."""
    return (reading["forward_max_abs_err"] <= 1e-4
            and reading["loss_max_rel_err"] <= 1e-4
            and reading["param_max_abs_err"] <= 1e-4)


def phase_moe(torch):
    """``gpt_lm(**LM, moe_experts=8)`` at full width on the card:

    1. ``SingleTrainer`` in bf16, batch 16, 2 epochs of 4 steps,
       ``aux_weight`` 0.01: K1-K3 once per block per step, the loss falls,
       the aux state finite;
    2. f32 on the card against the same run on the CPU (batch 4, 2 steps)
       within ``moe_f32_ok``, and the same run on the card with TF32 on,
       which must miss it;
    3. the f32 model served by ``DecodeEngine`` (plain), 4 greedy
       requests: every answer equals ``generate_tokens``, K1 once per
       block per cold join.
    Returns (row, [(path, kernel_launches)])."""
    import numpy as np
    from distkeras_tpu_torch import SingleTrainer
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    from distkeras_tpu_torch.utils.tree import tree_leaves
    t_phase = time.perf_counter()
    blocks = MOE_LM["num_blocks"]
    batch, steps, epochs = 16, 4, 2
    ds = _lm_rows(batch * steps)
    t = SingleTrainer(zoo.gpt_lm(**MOE_LM), "sgd", SCE, batch_size=batch,
                      learning_rate=0.1, compute_dtype="bfloat16",
                      num_epoch=epochs, aux_weight=MOE_AUX_WEIGHT)
    _reset_peak(torch)
    reset_launches()
    t.train(ds)
    launches, train_kernels = _launch_counts(), kernel_launches()
    hist = t.get_averaged_history()
    aux = [float(a) for a in tree_leaves(t.trained_variables["state"])]
    check(all(bool(np.isfinite(h).all()) for h in t.get_history()),
          "moe_train: a training loss is not finite")
    check(hist[-1] < hist[0], f"moe_train: the loss did not fall: {hist}")
    check(len(aux) == blocks and all(np.isfinite(a) and a > 0 for a in aux),
          f"moe_train: the aux state {aux}")
    want = blocks * steps * epochs
    check(all(n == want for n in launches.values()),
          f"moe_train: launches {launches} != {want} each")
    rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
    train = {"batch_size": batch, "steps_per_epoch": steps,
             "epochs": epochs, "compute_dtype": "bfloat16",
             "aux_weight": MOE_AUX_WEIGHT, "epoch_mean_loss": hist.tolist(),
             "aux_loss": aux, "step_ms": 1e3 * rec["epoch_seconds"] / steps,
             "samples_per_s": rec["samples_per_sec"],
             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
             "launches": launches, "kernel_launches": train_kernels}
    del t

    # f32: the card against the CPU, and the TF32-on control
    f32_batch, f32_steps = 4, 2
    t0 = time.perf_counter()
    cpu = _moe_f32_run(torch, "cpu", f32_batch, f32_steps)
    cpu_s = time.perf_counter() - t0
    card = _moe_f32_run(torch, "cuda", f32_batch, f32_steps)
    control = _moe_f32_run(torch, "cuda", f32_batch, f32_steps, tf32=True)
    reading = _moe_f32_reading(card, cpu)
    control_reading = _moe_f32_reading(control, cpu)
    check(moe_f32_ok(reading), f"moe_train_f32: card vs CPU {reading}")
    check(not moe_f32_ok(control_reading),
          f"moe_train_f32: the TF32-on control met the f32 bound "
          f"{control_reading}; the check is not live")
    f32_kernels = card[4]
    check(all(n == blocks * f32_steps for _, _, _, n in f32_kernels)
          and len(f32_kernels) == 3,
          f"moe_train_f32: launches {f32_kernels}")
    f32 = {"batch_size": f32_batch, "steps": f32_steps,
           "losses_cuda": card[1].tolist(), "losses_cpu": cpu[1].tolist(),
           "cuda_vs_cpu": reading, "cuda_tf32_vs_cpu": control_reading,
           "cpu_run_s": cpu_s, "kernel_launches": f32_kernels}
    del cpu, card, control

    # f32 serving: 4 greedy requests against generate_tokens
    model = zoo.gpt_lm(**MOE_LM).init(seed=0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, MOE_LM["vocab_size"], size=n)
               for n in PROMPT_LENS[:4]]
    registry, reqs, wall, _, served, served_kernels = serve_traffic(
        model, prompts)
    mismatches = _answers_match(torch, model, prompts,
                                [r.result() for r in reqs])
    joins = int(registry.snapshot()["serve.joins"]["value"])
    check(joins == len(prompts) and served == blocks * joins,
          f"moe_serve: flash_fwd launches {served} != {blocks} x {joins} "
          f"joins")
    tokens = int(registry.snapshot()["serve.tokens_out"]["value"])
    serve = {"requests": len(reqs), "joins": joins, "launches": served,
             "kernel_launches": served_kernels, "wall_s": wall,
             "tokens_per_s": tokens / wall, "mismatches": mismatches,
             "ttft_ms_p50": 1e3 * float(np.median(
                 [r.first_token_t - r.submit_t for r in reqs]))}
    del model
    row = {"phase": "moe", "model": MOE_LM, "train": train,
           "train_f32": f32, "serve": serve,
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    return row, [("moe_train", train_kernels), ("moe_train_f32", f32_kernels),
                 ("moe_serve", served_kernels)]


# ---------------------------------------------------------------------------
# the mesh: two ranks on the one card
# ---------------------------------------------------------------------------

#: the ``mesh`` phase's runs: the probe LM at seq_len 2048 on an ``sp``
#: mesh of 2 (T 1024 a rank; batch 2, 2 epochs of 2 steps), ADAG and
#: DOWNPOUR at 4 workers over the 2 ranks (f32, so that the edge's other
#: sum order is all that differs: in bf16 a 1-ulp change of an f32 master
#: can flip its bf16 rounding, and the runs drift apart at bf16's 4e-3;
#: batch 8, 2 epochs of 2 windows of 2 steps), ResNet-20 with BatchNorm over the ``workers`` axis (batch 64
#: a rank, f32), the MoE probe on an ``ep`` mesh of 2 (batch 2, f32), and
#: DOWNPOUR's async cluster (bf16, batch 8, 2 windows of 2 a worker)
MESH = dict(ranks=2, ring_T=2048, ring_batch=2, ring_steps=2,
            ring_epochs=2, sync_workers=4, sync_batch=8, sync_window=2,
            sync_windows=2, bn_batch=64, moe_batch=2, cluster_batch=8,
            cluster_window=2, cluster_windows=2, timeout_s=240)
RING_LAYOUTS = ("contiguous", "zigzag", "ulysses")
#: K1 launches of one ring forward per attention layer, by layout and
#: rank, at P = 2: contiguous causal runs the home block and, on rank 1,
#: rank 0's block (rank 0 skips rank 1's); zigzag 3 half blocks at home
#: and 1 for the other rank's block; Ulysses one whole-T call over its
#: head group.  Each K1 call under a gradient adds one K2 and one K3.
RING_K1 = {"contiguous": (1, 2), "zigzag": (4, 4), "ulysses": (1, 1)}
#: the mesh runs against their one-process oracles on the card, f32: the
#: logits and losses within rtol 1e-4 plus 1e-4 of the largest |value|,
#: each gradient and trained leaf within 1e-3 of its largest |value| (the
#: ring's hops merge through f32 logsumexps where the oracle runs one
#: kernel over the whole T, and the f32 kernels differ at the 1e-6 level
#: (``k1``, ``k2k3``)); bf16 losses within rtol 2e-2 (bf16 rounding, P
#: rounded per hop)
MESH_F32 = dict(rtol=1e-4, atol_of_max=1e-4, leaf_of_max=1e-3)
MESH_BF16_LOSS_RTOL = 2e-2
#: ``mesh_bn`` holds the pmean'd statistics in float64 (ResNet-20 cast
#: with ``.double()``, oracle and ranks) within 1e-9 of each leaf's
#: largest |value|; in f32 the gradient leaves within ``F32_STEP_REL``
#: of the oracle's in norm, the bound ``conv`` holds an f32 ResNet-20 to
#: (its E[x²] − E[x]² statistics round in f32: on an H100 at 700 W the
#: first mesh run read a leaf 2.5% off at its largest |value|)
MESH_F64_LEAF_OF_MAX = 1e-9
#: ``mesh_spmd`` / ``mesh_pipe``: the probe LM at full width trained by
#: ``SpmdTrainer`` (``SPMD_MESHES``) and ``PipelineTrainer`` (pp 2, M =
#: ``PIPE_M``: 2 stages of 2 blocks) against a one-process
#: ``SingleTrainer`` oracle on the card: Adam at lr ``SPMD_LR``, batch 8,
#: 2 epochs of 2 steps, f32 and bf16 (the bounds above)
SPMD = dict(batch=8, steps=2, epochs=2, lr=1e-3)
#: (run, mesh shape, compute dtype): mp 2 in both dtypes, dp 2 in f32
SPMD_MESHES = (("mp2_float32", {"dp": 1, "mp": 2}, None),
               ("mp2_bfloat16", {"dp": 1, "mp": 2}, "bfloat16"),
               ("dp2_float32", {"dp": 2, "mp": 1}, None))
PIPE_M = 4
#: the runs of a mesh rank, in order (``seconds_by_run``; ``fold`` runs on
#: rank 0 alone)
MESH_RUNS = ("ring", "sync", "bn", "moe", "spmd", "pipe", "zigzag", "fold",
             "cluster")


def _mesh_leaf_err(got, ref) -> float:
    """The largest |got − ref| of a leaf over its largest |ref|."""
    ref = ref.float()
    top = float(ref.abs().max())
    return float((got.float() - ref).abs().max()) / (top if top else 1.0)


def _mesh_close(got, ref, rtol, atol_of_max) -> float:
    """The largest |got − ref| − rtol·|ref| over atol_of_max·max|ref|: at
    most 1 when within the bound."""
    got, ref = got.double(), ref.double()
    slack = (got - ref).abs() - rtol * ref.abs()
    return float(slack.max()) / (atol_of_max * float(ref.abs().max()))


def _mesh_tokens(torch, lm, batch, seed, dev):
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.integers(0, lm["vocab_size"], size=(batch, lm["seq_len"]))
    y = (x + 1) % lm["vocab_size"]
    return (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))


def _mesh_fwd_grad(torch, model, x, y, aux_weight=0.0):
    """(logits, loss, {name: grad}) of the sparse cross-entropy, the
    model's aux losses folded in at ``aux_weight``."""
    from distkeras_tpu_torch.ops.losses import sparse_categorical_crossentropy
    from distkeras_tpu_torch.parallel.sync import aux_losses
    logits = model(x)
    loss = sparse_categorical_crossentropy(logits, y)
    aux = aux_losses(model)
    if aux_weight and aux:
        loss = loss + aux_weight * sum(aux)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    return logits.detach(), loss.detach(), dict(zip(names, grads))


def _mesh_train(torch, model, ds, batch, epochs, dtype, **kw):
    """``SingleTrainer`` on ``ds``: (losses (epochs·steps,), {name: trained
    parameter}, ms a step of the last epoch)."""
    import numpy as np
    from distkeras_tpu_torch import SingleTrainer
    t = SingleTrainer(model, "sgd", SCE, batch_size=batch,
                      learning_rate=0.1, num_epoch=epochs,
                      compute_dtype=dtype, **kw)
    t.train(ds)
    steps = len(t.get_history()[0])
    rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
    return (np.concatenate(t.get_history()),
            {n: p.detach().clone() for n, p in model.named_parameters()},
            1e3 * rec["epoch_seconds"] / steps)


def _mesh_ring_lm():
    return dict(LM, seq_len=MESH["ring_T"])


def _mesh_bn_model():
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.models.layers import BatchNorm
    model = zoo.resnet20()
    for lyr in model.iter_layers():
        if isinstance(lyr, BatchNorm):
            lyr.axis_name = "workers"
    return model


def _mesh_bn_data(torch, dev):
    import numpy as np
    rng = np.random.default_rng(11)
    n = MESH["ranks"] * MESH["bn_batch"]
    x = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=n)]
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _mesh_bn_loss(torch, out, y):
    """The summed cross-entropy of a batch, so the ranks' losses add up to
    the concatenated batch's."""
    return -(y * torch.log(out.clamp_min(1e-7))).sum()


def _mesh_oracle(torch, dev):
    """The one-process oracles on the card, and their step times."""
    import numpy as np
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.models.layers import BatchNorm
    from distkeras_tpu_torch.ops import moe
    from distkeras_tpu_torch.data import load_lm_corpus
    out, ms = {}, {}
    lm = _mesh_ring_lm()
    x, y = _mesh_tokens(torch, lm, MESH["ring_batch"], 21, dev)
    model = zoo.gpt_lm(**lm).init(0, device=dev)
    logits, loss, grads = _mesh_fwd_grad(torch, model, x, y)
    out["ring"] = {"logits": logits, "loss": loss, "grads": grads}
    ds = load_lm_corpus(n_train=MESH["ring_batch"] * MESH["ring_steps"],
                        seq_len=lm["seq_len"], vocab_size=lm["vocab_size"])[0]
    for dtype in ("float32", "bfloat16"):
        losses, params, step = _mesh_train(
            torch, model, ds, MESH["ring_batch"], MESH["ring_epochs"],
            None if dtype == "float32" else dtype, device=dev)
        out["ring"][dtype] = {"losses": losses,
                              "params": params if dtype == "float32"
                              else None}
        ms[f"ring_{dtype}"] = step
    del model
    sync_rows = MESH["sync_workers"] * MESH["sync_windows"] \
        * MESH["sync_window"] * MESH["sync_batch"]
    ds = _lm_rows(sync_rows)
    out["sync"] = {}
    for name in ("ADAG", "DOWNPOUR"):
        t = getattr(dkt, name)(
            zoo.gpt_lm(**LM), "sgd", SCE, num_workers=MESH["sync_workers"],
            batch_size=MESH["sync_batch"],
            communication_window=MESH["sync_window"], learning_rate=0.1,
            num_epoch=2, device=dev)
        t.train(ds)
        rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
        out["sync"][name] = {
            "history": np.stack(t.get_history()),
            "center": {n: p.detach().clone()
                       for n, p in t.model.named_parameters()}}
        ms[f"sync_{name}"] = 1e3 * rec["epoch_seconds"] / (
            MESH["sync_windows"] * MESH["sync_window"])
    out["bn"] = {}
    for dtype in (torch.float32, torch.float64):
        bx, by = (a.to(dtype) for a in _mesh_bn_data(torch, dev))
        model = _mesh_bn_model()
        for lyr in model.iter_layers():
            if isinstance(lyr, BatchNorm):
                lyr.axis_name = None  # one process: the whole batch's stats
        model.init(0, device=dev).to(dtype).train(True)
        t0 = time.perf_counter()
        probs = model(bx)
        loss = _mesh_bn_loss(torch, probs, by)
        names = [n for n, _ in model.named_parameters()]
        g = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        ms[f"bn_{str(dtype)[6:]}"] = 1e3 * (time.perf_counter() - t0)
        out["bn"][str(dtype)[6:]] = {
            "out": probs.detach(), "grads": dict(zip(names, g)),
            "state": [lyr.new_state for lyr in model.iter_layers()
                      if isinstance(lyr, BatchNorm)]}
        del model
    moe_lm = MOE_LM
    x, y = _mesh_tokens(torch, moe_lm, MESH["moe_batch"], 23, dev)
    model = zoo.gpt_lm(**moe_lm).init(0, device=dev).train(True)
    dense = moe.dense_moe
    # the oracle's MoE block: the two-rank dispatch in one process
    moe.dense_moe = lambda params, tokens: moe.switch_moe_reference(
        params, tokens, MESH["ranks"], 1.25)
    try:
        t0 = time.perf_counter()
        logits, loss, grads = _mesh_fwd_grad(torch, model, x, y,
                                             aux_weight=MOE_AUX_WEIGHT)
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        ms["moe"] = 1e3 * (time.perf_counter() - t0)
    finally:
        moe.dense_moe = dense
    out["moe"] = {"logits": logits, "loss": loss, "grads": grads}
    del model
    # mesh_spmd and mesh_pipe: the probe LM trained in one process
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    out["spmd"] = {}
    init = zoo.gpt_lm(**LM).init(0, device=dev)
    for dtype in ("float32", "bfloat16"):
        reset_launches()
        t = _spmd_oracle_trainer(torch, dev, dtype)
        t.train(_lm_rows(SPMD["batch"] * SPMD["steps"]))
        rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
        out["spmd"][dtype] = {
            "losses": np.concatenate(t.get_history()),
            "params": {n: p.detach().clone()
                       for n, p in t.model.named_parameters()},
            "init": {n: p.detach().clone()
                     for n, p in init.named_parameters()},
            "launches": _launches_by_k(kernel_launches())}
        ms[f"spmd_{dtype}"] = 1e3 * rec["epoch_seconds"] / SPMD["steps"]
        del t
    return out, ms


def _spmd_oracle_trainer(torch, dev, dtype):
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import zoo
    return dkt.SingleTrainer(
        zoo.gpt_lm(**LM), "adam", SCE, batch_size=SPMD["batch"],
        learning_rate=SPMD["lr"], num_epoch=SPMD["epochs"],
        compute_dtype=None if dtype == "float32" else dtype, device=dev)


def _launches_by_k(rows) -> dict:
    """[kernel, dtype, Dh, n] rows summed into K1 (``fwd``), K2 (``dq``)
    and K3 (``dkv``) launches, whichever kernel ran each."""
    counts = {"fwd": 0, "dq": 0, "dkv": 0}
    for k, _, _, n in rows:
        key = "dq" if k.startswith("flash_bwd_dq") else \
            "dkv" if k.startswith("flash_bwd_dkv") else "fwd"
        counts[key] += n
    return counts


def _mesh_attach(model, mesh, layout):
    from distkeras_tpu_torch.ops.attention import MultiHeadAttention
    for lyr in model.iter_layers():
        if isinstance(lyr, MultiHeadAttention):
            lyr.mesh = mesh
            if layout == "ulysses":
                lyr.ring_impl, lyr.ring_layout = "ulysses", None
            else:
                lyr.ring_impl, lyr.ring_layout = None, layout


def _mesh_path(torch, fn):
    """``fn()``'s result, this rank's K1–K3 launches and collective
    counts during it (each set to 0 just before)."""
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    from distkeras_tpu_torch.parallel import mesh as M
    reset_launches()
    M.reset_collective_stats()
    res = fn()
    return res, kernel_launches(), M.collective_stats()


def _mesh_ring_rank(torch, oracle, rank, dev):
    from distkeras_tpu_torch.data import load_lm_corpus
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.parallel import mesh as M
    lm = _mesh_ring_lm()
    mesh = M.make_mesh(axis_names=("sp",), shape=(MESH["ranks"],))
    x, y = _mesh_tokens(torch, lm, MESH["ring_batch"], 21, dev)
    ds = load_lm_corpus(n_train=MESH["ring_batch"] * MESH["ring_steps"],
                        seq_len=lm["seq_len"], vocab_size=lm["vocab_size"])[0]
    rows = {}
    for layout in RING_LAYOUTS:
        model = zoo.gpt_lm(**lm).init(0, device=dev)
        _mesh_attach(model, mesh, layout)

        def run():
            logits, loss, grads = _mesh_fwd_grad(torch, model, x, y)
            ref = oracle["ring"]
            row = {"logits": _mesh_close(logits, ref["logits"],
                                         MESH_F32["rtol"],
                                         MESH_F32["atol_of_max"]),
                   "loss": float(loss), "loss_ref": float(ref["loss"]),
                   "grads": max(_mesh_leaf_err(grads[n], ref["grads"][n])
                                for n in grads)}
            for dtype in ("float32", "bfloat16"):
                losses, params, step = _mesh_train(
                    torch, model, ds, MESH["ring_batch"],
                    MESH["ring_epochs"],
                    None if dtype == "float32" else dtype, device=dev)
                want = ref[dtype]["losses"]
                row[dtype] = {"losses": losses.tolist(),
                              "losses_ref": want.tolist(), "step_ms": step}
                if dtype == "float32":
                    row[dtype]["params"] = max(
                        _mesh_leaf_err(params[n], ref[dtype]["params"][n])
                        for n in params)
            return row
        row, launches, stats = _mesh_path(torch, run)
        row.update(kernel_launches=launches, collectives=stats)
        rows[layout] = row
        del model
    return rows


def _mesh_sync_rank(torch, oracle, rank, dev):
    import numpy as np
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(MESH["sync_workers"])
    rows = MESH["sync_workers"] * MESH["sync_windows"] \
        * MESH["sync_window"] * MESH["sync_batch"]
    ds = _lm_rows(rows)
    out = {}
    for name in ("ADAG", "DOWNPOUR"):
        def run():
            t = getattr(dkt, name)(
                zoo.gpt_lm(**LM), "sgd", SCE,
                num_workers=MESH["sync_workers"], mesh=mesh,
                batch_size=MESH["sync_batch"],
                communication_window=MESH["sync_window"],
                learning_rate=0.1, num_epoch=2)
            t.train(ds)
            ref = oracle["sync"][name]
            hist = np.stack(t.get_history())
            center = dict(t.model.named_parameters())
            rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
            return {
                "history_shape": list(hist.shape),
                "losses_bit_equal": bool(np.array_equal(hist,
                                                        ref["history"])),
                "losses_max_abs_diff": float(np.abs(
                    hist - ref["history"]).max()),
                "center_bit_equal": all(torch.equal(center[n], v)
                                        for n, v in ref["center"].items()),
                "center_max_leaf_err": max(
                    _mesh_leaf_err(center[n].detach(), v)
                    for n, v in ref["center"].items()),
                "center_digest": float(sum(p.detach().double().abs().sum()
                                           for p in center.values())),
                "step_ms": 1e3 * rec["epoch_seconds"] / (
                    MESH["sync_windows"] * MESH["sync_window"])}
        row, launches, stats = _mesh_path(torch, run)
        row.update(kernel_launches=launches, collectives=stats)
        out[name] = row
    return out


def _mesh_bn_rank(torch, oracle, rank, dev):
    from distkeras_tpu_torch.models.layers import BatchNorm
    from distkeras_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(MESH["ranks"])
    b = MESH["bn_batch"]

    def run(dtype):
        bx, by = (a.to(dtype) for a in _mesh_bn_data(torch, dev))
        x, y = bx[rank * b:(rank + 1) * b], by[rank * b:(rank + 1) * b]
        model = _mesh_bn_model().init(0, device=dev).to(dtype).train(True)
        t0 = time.perf_counter()
        with mesh:
            probs = model(x)
            loss = _mesh_bn_loss(torch, probs, y)
            names = [n for n, _ in model.named_parameters()]
            g = torch.autograd.grad(loss, [p for _, p in
                                           model.named_parameters()])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        # the ranks' gradients sum to the concatenated batch's
        total = {n: M.sum_slots(gi.detach()[None], mesh=mesh)
                 for n, gi in zip(names, g)}
        ref = oracle["bn"][str(dtype)[6:]]
        states = [lyr.new_state for lyr in model.iter_layers()
                  if isinstance(lyr, BatchNorm)]
        return {"out": _mesh_close(probs.detach(),
                                   ref["out"][rank * b:(rank + 1) * b],
                                   MESH_F32["rtol"],
                                   MESH_F32["atol_of_max"]),
                "grads": max(_mesh_leaf_err(total[n], ref["grads"][n])
                             for n in total),
                "grads_rel_norm": max(
                    float((total[n] - ref["grads"][n]).norm()
                          / ref["grads"][n].norm()) for n in total),
                "state": max(_mesh_leaf_err(s[k], r[k])
                             for s, r in zip(states, ref["state"])
                             for k in ("mean", "var")),
                "step_ms": ms}
    row, launches, stats = _mesh_path(
        torch, lambda: {str(d)[6:]: run(d)
                        for d in (torch.float32, torch.float64)})
    row["collectives"] = stats
    return row


def _mesh_moe_rank(torch, oracle, rank, dev):
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.moe import MoEDense
    from distkeras_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(axis_names=("ep",), shape=(MESH["ranks"],))
    x, y = _mesh_tokens(torch, MOE_LM, MESH["moe_batch"], 23, dev)
    model = zoo.gpt_lm(**MOE_LM)
    for lyr in model.iter_layers():
        if isinstance(lyr, MoEDense):
            lyr.mesh = mesh
    model.init(0, device=dev).train(True)
    e_loc = MOE_LM["moe_experts"] // MESH["ranks"]

    def run():
        t0 = time.perf_counter()
        logits, loss, grads = _mesh_fwd_grad(torch, model, x, y,
                                             aux_weight=MOE_AUX_WEIGHT)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        ref = oracle["moe"]
        errs = {}
        for n, g in grads.items():
            want = ref["grads"][n]
            if ".experts." in n:
                want = want[rank * e_loc:(rank + 1) * e_loc]
            errs[n] = _mesh_leaf_err(g, want)
        return {"logits": _mesh_close(logits, ref["logits"],
                                      MESH_F32["rtol"],
                                      MESH_F32["atol_of_max"]),
                "loss": float(loss), "loss_ref": float(ref["loss"]),
                "grads": max(errs.values()), "experts_per_rank": e_loc,
                "step_ms": ms}
    row, launches, stats = _mesh_path(torch, run)
    row.update(kernel_launches=launches, collectives=stats)
    return row


def _mesh_cluster_rank(torch, port, rank, dev):
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ps.cluster import run_cluster_async_training
    rows = MESH["ranks"] * MESH["cluster_windows"] \
        * MESH["cluster_window"] * MESH["cluster_batch"]
    ds = _lm_rows(rows)

    def run():
        t = dkt.DOWNPOUR(zoo.gpt_lm(**LM), "sgd", SCE,
                         num_workers=MESH["ranks"],
                         batch_size=MESH["cluster_batch"],
                         communication_window=MESH["cluster_window"],
                         learning_rate=0.1, compute_dtype="bfloat16",
                         num_epoch=1, device=dev)
        t0 = time.perf_counter()
        m = run_cluster_async_training(t, ds, ps_address=("127.0.0.1", port))
        row = {"wall_s": time.perf_counter() - t0,
               "center_digest": float(sum(p.detach().double().abs().sum()
                                          for p in m.parameters()))}
        if rank == 0:
            row["commits_by_worker"] = {
                str(k): v for k, v in t.ps_stats["commits_by_worker"].items()}
            row["num_updates"] = t.ps_stats["num_updates"]
        return row
    row, launches, stats = _mesh_path(torch, run)
    row.update(kernel_launches=launches, collectives=stats)
    return row


def _trainer_readings(torch, t, ref, dtype):
    """A mesh trainer's losses and, in f32, its largest trained-leaf error
    against the oracle ``ref``, and its ms a step (last epoch)."""
    import numpy as np
    losses = np.concatenate(t.get_history())
    rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
    row = {"losses": losses.tolist(), "losses_ref": ref["losses"].tolist(),
           "step_ms": 1e3 * rec["epoch_seconds"] / SPMD["steps"]}
    if dtype == "float32":
        got = dict(t.model.named_parameters())
        row["params"] = max(_mesh_leaf_err(p.detach(), ref["params"][n])
                            for n, p in got.items())
        row["params_step_rel"] = max(
            float((got[n].detach() - ref["params"][n]).norm()
                  / (ref["params"][n] - p0).norm().clamp_min(1e-30))
            for n, p0 in ref["init"].items())
    return row


def _device_spy(t, seen: set):
    """Wrap ``t._start`` so that every parameter block it trains, every
    optimizer-state tensor and every gradient that reaches a parameter
    records its device type in ``seen``."""
    start = t._start

    def spy(optimizer):
        params, opt_state, ckpt, first = start(optimizer)
        for p in params.values():
            seen.add(p.device.type)
            p.register_hook(lambda g: seen.add(g.device.type))
        for v in opt_state.values():
            if isinstance(v, dict):
                seen.update(x.device.type for x in v.values())
        return params, opt_state, ckpt, first
    t._start = spy


def _mesh_spmd_rank(torch, oracle, rank, dev):
    from distkeras_tpu_torch import SpmdTrainer
    from distkeras_tpu_torch.models import zoo
    ds = _lm_rows(SPMD["batch"] * SPMD["steps"])
    out = {}
    for run_name, shape, dtype in SPMD_MESHES:
        key = dtype or "float32"
        seen = set()

        def run():
            t = SpmdTrainer(zoo.gpt_lm(**LM), "adam", SCE, mesh_shape=shape,
                            batch_size=SPMD["batch"],
                            learning_rate=SPMD["lr"],
                            num_epoch=SPMD["epochs"], compute_dtype=dtype)
            _device_spy(t, seen)
            t.train(ds)
            row = _trainer_readings(torch, t, oracle["spmd"][key], key)
            rep = t.sharding_report
            row.update(global_bytes=rep["global_bytes"],
                       per_device_bytes=rep["per_device_bytes"])
            return row
        row, launches, stats = _mesh_path(torch, run)
        row.update(kernel_launches=launches, collectives=stats,
                   devices=sorted(seen), dtype=key,
                   launches_ref=oracle["spmd"][key]["launches"])
        out[run_name] = row
    return out


def _mesh_pipe_rank(torch, oracle, rank, dev):
    from distkeras_tpu_torch import PipelineTrainer
    from distkeras_tpu_torch.models import zoo
    ds = _lm_rows(SPMD["batch"] * SPMD["steps"])
    out = {}
    for dtype in ("float32", "bfloat16"):
        seen = set()

        def run():
            t = PipelineTrainer(
                zoo.gpt_lm(**LM), "adam", SCE, mesh_shape={"pp": 2},
                num_microbatches=PIPE_M, batch_size=SPMD["batch"],
                learning_rate=SPMD["lr"], num_epoch=SPMD["epochs"],
                compute_dtype=None if dtype == "float32" else dtype)
            t.train(ds)
            row = _trainer_readings(torch, t, oracle["spmd"][dtype], dtype)
            stage = sum(t._params[k].numel() * t._params[k].element_size()
                        for k in t._stage_keys)
            seen.update(p.device.type for p in t._params.values())
            layers = t.model.layer.layers
            a = 2  # [Emb, Pos, (Res, FF) × blocks, LN, Dense]
            stack = sum(p.numel() * p.element_size()
                        for lyr in layers[a:a + 2 * LM["num_blocks"]]
                        for p in lyr.parameters())
            row.update(stage_bytes=stage, stack_bytes=stack)
            return row
        row, launches, stats = _mesh_path(torch, run)
        row.update(kernel_launches=launches, collectives=stats,
                   devices=sorted(seen))
        out[dtype] = row
    return out


def _mesh_zigzag_rank(torch, oracle, rank, dev):
    """``zigzag_wrap`` of the ring LM on sp 2 against the unwrapped
    zigzag ring (each attention layer striping its own inputs): logits,
    gradients, stripe passes (``_take_chunks`` calls) and launches."""
    from distkeras_tpu_torch.models import zigzag_wrap, zoo
    from distkeras_tpu_torch.parallel import mesh as M
    from distkeras_tpu_torch.parallel import ring
    lm = _mesh_ring_lm()
    mesh = M.make_mesh(axis_names=("sp",), shape=(MESH["ranks"],))
    x, y = _mesh_tokens(torch, lm, MESH["ring_batch"], 21, dev)
    model = zoo.gpt_lm(**lm).init(0, device=dev)
    take, stripes = ring._take_chunks, [0]

    def counted(*a):
        stripes[0] += 1
        return take(*a)
    ring._take_chunks = counted
    try:
        wrapped, pos = zigzag_wrap(model, mesh)

        def run():
            stripes[0] = 0
            t0 = time.perf_counter()
            logits, loss, grads = _mesh_fwd_grad(torch, wrapped, x, y)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return logits, loss, grads, stripes[0], \
                1e3 * (time.perf_counter() - t0)
        (logits, loss, grads, wrapped_stripes, ms), launches, stats = \
            _mesh_path(torch, run)
        # the wrapped stack's parameters are the original's, under names
        # shifted by the stripe layers
        name = {id(p): n for n, p in model.named_parameters()}
        grads = {name[id(p)]: grads[n]
                 for n, p in wrapped.named_parameters()}
        _mesh_attach(model, mesh, "zigzag")
        stripes[0] = 0
        t0 = time.perf_counter()
        ref_logits, ref_loss, ref_grads = _mesh_fwd_grad(torch, model, x, y)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ref_ms = 1e3 * (time.perf_counter() - t0)
        ring_stripes = stripes[0]
    finally:
        ring._take_chunks = take
    return {"logits": _mesh_close(logits, ref_logits, MESH_F32["rtol"],
                                  MESH_F32["atol_of_max"]),
            "loss": float(loss), "loss_ref": float(ref_loss),
            "grads": max(_mesh_leaf_err(grads[n], ref_grads[n])
                         for n in grads),
            "positions": list(pos), "stripes": wrapped_stripes,
            "ring_stripes": ring_stripes, "step_ms": ms,
            "ring_step_ms": ref_ms, "kernel_launches": launches,
            "collectives": stats}


def _mesh_fold_rank(torch, dev):
    """``fold_batchnorm`` of a ResNet-20 (its BatchNorm statistics moved
    off their init) against its unfolded forward, eval mode, f32, and
    both forwards' ms at batch ``MESH["bn_batch"]``."""
    import numpy as np
    from distkeras_tpu_torch.models import fold_batchnorm, zoo
    from distkeras_tpu_torch.models.layers import BatchNorm
    model = zoo.resnet20().init(0, device=dev)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for lyr in model.iter_layers():
            if isinstance(lyr, BatchNorm):
                c = lyr.mean.shape[0]
                lyr.mean.copy_(0.2 * torch.randn(c, generator=gen))
                lyr.var.copy_(0.5 + torch.rand(c, generator=gen))
                lyr.bias.add_(0.05 * torch.randn(c, generator=gen).to(dev))
    folded = fold_batchnorm(model)
    x, _ = _mesh_bn_data(torch, dev)
    x = x[:MESH["bn_batch"]]
    times = {}
    with torch.no_grad():
        for name, m in (("unfolded", model), ("folded", folded)):
            m(x)
            torch.cuda.synchronize(dev) if dev.type == "cuda" else None
            t0 = time.perf_counter()
            y = m(x)
            torch.cuda.synchronize(dev) if dev.type == "cuda" else None
            times[name] = (y, 1e3 * (time.perf_counter() - t0))
    (y0, ms0), (y1, ms1) = times["unfolded"], times["folded"]
    return {"out": _mesh_close(y1, y0, MESH_F32["rtol"],
                               MESH_F32["atol_of_max"]),
            "batchnorms_left": sum(isinstance(lyr, BatchNorm)
                                   for lyr in folded.iter_layers()),
            "finite": bool(np.isfinite(y1.cpu().numpy()).all()),
            "ms": ms1, "unfolded_ms": ms0}


def _mesh_rank(workdir: str, rank: int) -> int:
    """One rank of the ``mesh`` phase (``chip_smoke.py --mesh-rank DIR
    R``): forms the gloo group, runs every run against the oracles the
    parent wrote, and writes its readings to DIR/rank{R}.json."""
    import torch
    import torch.distributed as dist
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    # the parent's configurations (a rehearsal shrinks them)
    globals().update(spec["configs"])
    cpu = spec["device"] == "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from distkeras_tpu_torch.parallel import mesh as M
    from distkeras_tpu_torch.parallel import multihost
    multihost.initialize(spec["addr"], MESH["ranks"], rank,
                         device="cpu" if cpu else None,
                         timeout_s=MESH["timeout_s"])
    dev = multihost.rank_device()
    oracle = torch.load(os.path.join(workdir, "oracle.pt"),
                        map_location=dev, weights_only=False)
    t0 = time.perf_counter()
    out = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "backend_reason": multihost.backend_reason(),
           "routes": {op: M.route(op, torch.zeros(1, device=dev),
                                  dist.group.WORLD)
                      for op in ("all_reduce", "broadcast", "all_gather",
                                 "all_to_all", "ppermute")}}
    for name, fn in (("ring", _mesh_ring_rank), ("sync", _mesh_sync_rank),
                     ("bn", _mesh_bn_rank), ("moe", _mesh_moe_rank),
                     ("spmd", _mesh_spmd_rank), ("pipe", _mesh_pipe_rank),
                     ("zigzag", _mesh_zigzag_rank)):
        t1 = time.perf_counter()
        out[name] = fn(torch, oracle, rank, dev)
        out[f"{name}_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    if rank == 0:  # one rank: no collective
        out["fold"] = _mesh_fold_rank(torch, dev)
    out["fold_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["cluster"] = _mesh_cluster_rank(torch, spec["cluster_port"], rank,
                                        dev)
    out["cluster_s"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    multihost.shutdown()
    return 0


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mesh_losses_ok(what, row, dtype):
    tol = MESH_F32["rtol"] if dtype == "float32" else MESH_BF16_LOSS_RTOL
    got, want = row["losses"], row["losses_ref"]
    check(len(got) == len(want) and all(abs(a - b) <= tol * abs(b)
                                        for a, b in zip(got, want)),
          f"{what}: {dtype} losses {got} vs {want}")
    if dtype == "float32":
        # Adam normalises each update, so a gradient component near 0
        # moves its parameter by ~lr whatever its f32 rounding: a run whose
        # K1 takes another kernel than the oracle's (dp 2's batch 4 and
        # pp's microbatch 2 fall under the 3xTF32 grid rule, onto CUDA
        # cores) read 1.2e-3 and 1.4e-3 of a leaf's largest |value|
        # elementwise at equal losses on an H100 at 700 W.  So the f32
        # trained leaves are held in norm, each leaf's change within
        # F32_STEP_REL of the oracle's; the elementwise reading is reported
        check(row["params_step_rel"] <= F32_STEP_REL,
              f"{what}: trained f32 parameters' change "
              f"{row['params_step_rel']} (elementwise {row['params']})")


def _mesh_trainer_checks(r, res):
    """``mesh_spmd``, ``mesh_pipe`` and ``mesh_zigzag`` on rank ``r``."""
    dev = res["device"].split(":")[0]
    for run, shape, _ in SPMD_MESHES:
        row = res["spmd"][run]
        what = f"mesh_spmd {run} rank {r}"
        _mesh_losses_ok(what, row, row["dtype"])
        split = row["per_device_bytes"] < row["global_bytes"]
        check(split == (shape["mp"] > 1),
              f"{what}: per-device bytes {row['per_device_bytes']} of "
              f"{row['global_bytes']}")
        check(row["devices"] == [dev],
              f"{what}: parameter blocks, optimizer state and gradients "
              f"on {row['devices']}, not {dev}")
        got = _launches_by_k(row["kernel_launches"])
        check(got == row["launches_ref"],
              f"{what}: launches {got}, the oracle's "
              f"{row['launches_ref']}")
    steps = SPMD["epochs"] * SPMD["steps"]
    stages = 2
    ticks = PIPE_M + stages - 1
    for dtype, row in res["pipe"].items():
        what = f"mesh_pipe {dtype} rank {r}"
        _mesh_losses_ok(what, row, dtype)
        check(row["stage_bytes"] * stages == row["stack_bytes"],
              f"{what}: stage {row['stage_bytes']} of the stack's "
              f"{row['stack_bytes']} bytes")
        check(row["devices"] == [dev], f"{what}: on {row['devices']}")
        want = ticks * LM["num_blocks"] // stages * steps
        got = _launches_by_k(row["kernel_launches"])
        check(got == {"fwd": want, "dq": want, "dkv": want},
              f"{what}: launches {got}, want {want} each of K1, K2, K3 "
              f"((M + S − 1) × blocks a stage × steps)")
    zz = res["zigzag"]
    what = f"mesh_zigzag rank {r}"
    check(zz["logits"] <= 1.0 and zz["grads"] <= MESH_F32["leaf_of_max"]
          and abs(zz["loss"] - zz["loss_ref"])
          <= MESH_F32["rtol"] * abs(zz["loss_ref"]),
          f"{what}: against the unwrapped zigzag ring {zz}")
    check(zz["stripes"] == 2 and zz["ring_stripes"]
          == 4 * LM["num_blocks"],
          f"{what}: stripe passes {zz['stripes']} (the unwrapped ring's "
          f"{zz['ring_stripes']})")
    want = LM["num_blocks"] * RING_K1["zigzag"][r]
    got = _launches_by_k(zz["kernel_launches"])
    check(got == {"fwd": want, "dq": want, "dkv": want},
          f"{what}: launches {got}, want {want} each")


def _mesh_checks(ranks):
    """Every rank's readings against the bounds and the schedule."""
    blocks = LM["num_blocks"]
    passes = 1 + 2 * MESH["ring_epochs"] * MESH["ring_steps"]
    for r, res in enumerate(ranks):
        check(res["backend"] == "gloo",
              f"mesh: rank {r} formed a {res['backend']} group on one card")
        for layout, row in res["ring"].items():
            what = f"mesh_ring {layout} rank {r}"
            check(row["logits"] <= 1.0, f"{what}: logits {row['logits']}")
            check(abs(row["loss"] - row["loss_ref"])
                  <= MESH_F32["rtol"] * abs(row["loss_ref"]),
                  f"{what}: loss {row['loss']} vs {row['loss_ref']}")
            check(row["grads"] <= MESH_F32["leaf_of_max"],
                  f"{what}: gradients {row['grads']}")
            f32 = row["float32"]
            check(f32["params"] <= MESH_F32["leaf_of_max"],
                  f"{what}: trained f32 parameters {f32['params']}")
            for dtype, tol in (("float32", MESH_F32["rtol"]),
                               ("bfloat16", MESH_BF16_LOSS_RTOL)):
                got, want = row[dtype]["losses"], row[dtype]["losses_ref"]
                check(all(abs(a - b) <= tol * abs(b)
                          for a, b in zip(got, want)),
                      f"{what}: {dtype} losses {got} vs {want}")
            want = blocks * RING_K1[layout][r] * passes
            counts = {}
            for k, _, _, n in row["kernel_launches"]:
                key = "dq" if k.startswith("flash_bwd_dq") else \
                    "dkv" if k.startswith("flash_bwd_dkv") else "fwd"
                counts[key] = counts.get(key, 0) + n
            check(counts == {"fwd": want, "dq": want, "dkv": want},
                  f"{what}: launches {row['kernel_launches']}, want "
                  f"{want} each of K1, K2 and K3")
        for name, row in res["sync"].items():
            check(row["center_max_leaf_err"] <= MESH_F32["leaf_of_max"],
                  f"mesh_sync {name} rank {r}: center "
                  f"{row['center_max_leaf_err']}")
            check(row["history_shape"][1:] == [
                MESH["sync_workers"],
                MESH["sync_windows"] * MESH["sync_window"]],
                  f"mesh_sync {name} rank {r}: history "
                  f"{row['history_shape']}")
        f32, f64 = res["bn"]["float32"], res["bn"]["float64"]
        check(f64["out"] <= 1.0 and f64["grads"] <= MESH_F64_LEAF_OF_MAX
              and f64["state"] <= MESH_F64_LEAF_OF_MAX,
              f"mesh_bn float64 rank {r}: {f64}")
        check(f32["out"] <= 1.0 and f32["grads_rel_norm"] <= F32_STEP_REL
              and f32["state"] <= MESH_F32["leaf_of_max"],
              f"mesh_bn float32 rank {r}: {f32}")
        moe = res["moe"]
        check(moe["logits"] <= 1.0 and moe["grads"] <= MESH_F32[
            "leaf_of_max"], f"mesh_moe rank {r}: {moe}")
        _mesh_trainer_checks(r, res)
    for name in ("ADAG", "DOWNPOUR"):
        check(len({res["sync"][name]["center_digest"] for res in ranks}) == 1,
              f"mesh_sync {name}: the ranks' centers differ")
    fold = ranks[0]["fold"]
    check(fold["out"] <= 1.0 and fold["finite"]
          and fold["batchnorms_left"] == 0, f"mesh_fold: {fold}")
    check(len({res["cluster"]["center_digest"] for res in ranks}) == 1,
          "mesh_cluster: the ranks returned different centers")
    want = MESH["cluster_windows"]
    got = ranks[0]["cluster"]["commits_by_worker"]
    check(got == {str(k): want for k in range(MESH["ranks"])}
          and ranks[0]["cluster"]["num_updates"] == want * MESH["ranks"],
          f"mesh_cluster: commits {got}, want {want} a worker")


def phase_mesh(torch, device="cuda"):
    """Two ranks on the one card (gloo: NCCL takes one rank a device),
    spawned once: ``mesh_ring`` (the probe LM at seq_len 2048 on an sp
    mesh of 2, contiguous, zigzag and Ulysses: forward and gradients, 2
    epochs of 2 ``SingleTrainer`` steps in f32 and in bf16, K1–K3 per
    rank as the schedule says), ``mesh_sync`` (ADAG and DOWNPOUR at 4
    workers, 2 a rank), ``mesh_bn`` (ResNet-20 with BatchNorm over the
    workers axis, one worker a rank), ``mesh_moe`` (the MoE probe on an
    ep mesh of 2), ``mesh_spmd`` (``SpmdTrainer`` on mp 2 and dp 2),
    ``mesh_pipe`` (``PipelineTrainer`` on pp 2), ``mesh_zigzag``
    (``zigzag_wrap`` against the unwrapped zigzag ring), ``mesh_fold``
    (``fold_batchnorm`` on rank 0) and ``mesh_cluster`` (DOWNPOUR's async
    cluster, the PS on rank 0).  Every multi-rank result is held against
    a one-process computation on the card (the oracle), computed first.
    Returns (row, [(path, kernel_launches)])."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    dev = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t0 = time.perf_counter()
        oracle, oracle_ms = _mesh_oracle(torch, dev)
        torch.save(oracle, os.path.join(workdir, "oracle.pt"))
        del oracle
        oracle_s = time.perf_counter() - t0
        with open(os.path.join(workdir, "spec.json"), "w") as f:
            json.dump({"device": device, "addr": f"127.0.0.1:{_free_port()}",
                       "cluster_port": _free_port(),
                       "configs": {"LM": LM, "MOE_LM": MOE_LM,
                                   "MESH": MESH}}, f)
        env = dict(os.environ, PYTHONPATH=ROOT)
        logs = [open(os.path.join(workdir, f"rank{r}.log"), "w")
                for r in range(MESH["ranks"])]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             workdir, str(r)], env=env, cwd=ROOT, stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(MESH["ranks"])]
        try:
            rcs = [p.wait(timeout=MESH["timeout_s"] + 60) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        ranks_s = time.perf_counter() - t0
        if any(rc != 0 for rc in (p.returncode for p in procs)):
            for r in range(MESH["ranks"]):
                with open(os.path.join(workdir, f"rank{r}.log")) as f:
                    print(f"--- mesh rank {r} ---\n{f.read()[-6000:]}",
                          file=sys.stderr)
            check(False, f"mesh: a rank failed: exit codes "
                         f"{[p.returncode for p in procs]}")
        ranks = []
        for r in range(MESH["ranks"]):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    hop = ranks[0]["ring"]["contiguous"]["collectives"]
    row = {"phase": "mesh", "ranks": MESH["ranks"], "device": device,
           "backend": ranks[0]["backend"],
           "backend_reason": ranks[0]["backend_reason"],
           "routes": ranks[0]["routes"],
           "host_bytes_per_ring_hop": hop["host_bytes"].get("ppermute", 0)
           / max(1, hop["host_calls"].get("ppermute", 0)),
           "oracle_step_ms": oracle_ms,
           "step_ms": {f"rank{r}": {
               **{f"ring_{layout}_{dtype}":
                  res["ring"][layout][dtype]["step_ms"]
                  for layout in RING_LAYOUTS
                  for dtype in ("float32", "bfloat16")},
               **{f"sync_{n}": res["sync"][n]["step_ms"]
                  for n in res["sync"]},
               **{f"bn_{d}": res["bn"][d]["step_ms"]
                  for d in ("float32", "float64")},
               "moe": res["moe"]["step_ms"],
               **{f"spmd_{n}": res["spmd"][n]["step_ms"]
                  for n in res["spmd"]},
               **{f"pipe_{d}": res["pipe"][d]["step_ms"]
                  for d in res["pipe"]},
               "zigzag": res["zigzag"]["step_ms"],
               "zigzag_unwrapped": res["zigzag"]["ring_step_ms"]}
               for r, res in enumerate(ranks)},
           "readings": {f"rank{r}": {
               "ring": {layout: {k: res["ring"][layout][k]
                                 for k in ("logits", "grads")}
                        | {"params_f32":
                           res["ring"][layout]["float32"]["params"]}
                        for layout in RING_LAYOUTS},
               "sync": {n: {k: v for k, v in res["sync"][n].items()
                            if k not in ("kernel_launches", "collectives")}
                        for n in res["sync"]},
               "bn": {d: {k: res["bn"][d][k] for k in
                          ("out", "grads", "grads_rel_norm", "state")}
                      for d in ("float32", "float64")},
               "moe": {k: res["moe"][k] for k in ("logits", "grads",
                                                  "loss", "loss_ref")},
               "cluster": {k: v for k, v in res["cluster"].items()
                           if k not in ("kernel_launches", "collectives")},
               "spmd": {n: {k: v for k, v in row.items()
                            if k not in ("kernel_launches", "collectives")}
                        for n, row in res["spmd"].items()},
               "pipe": {d: {k: v for k, v in row.items()
                            if k not in ("kernel_launches", "collectives")}
                        for d, row in res["pipe"].items()},
               "zigzag": {k: v for k, v in res["zigzag"].items()
                          if k not in ("kernel_launches", "collectives")}}
               for r, res in enumerate(ranks)},
           "fold": ranks[0]["fold"],
           "collectives": {f"rank{r}": {
               name: (res[name]["collectives"] if name in ("bn", "moe",
                                                           "cluster")
                      else {k: v["collectives"]
                            for k, v in res[name].items()})
               for name in ("ring", "sync", "bn", "moe", "cluster", "spmd",
                            "pipe")}
               | {"zigzag": res["zigzag"]["collectives"]}
               for r, res in enumerate(ranks)},
           "seconds_by_run": {f"rank{r}": {k: res[f"{k}_s"] for k in
                                            MESH_RUNS}
                              for r, res in enumerate(ranks)},
           "oracle_s": oracle_s, "ranks_s": ranks_s,
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    _mesh_checks(ranks)
    paths = []
    for r, res in enumerate(ranks):
        paths += [(f"mesh_ring_{layout}_r{r}",
                   res["ring"][layout]["kernel_launches"])
                  for layout in RING_LAYOUTS]
        paths += [(f"mesh_sync_{n.lower()}_r{r}",
                   res["sync"][n]["kernel_launches"]) for n in res["sync"]]
        paths += [(f"mesh_moe_r{r}", res["moe"]["kernel_launches"]),
                  (f"mesh_cluster_r{r}", res["cluster"]["kernel_launches"])]
        paths += [(f"mesh_spmd_{n}_r{r}", res["spmd"][n]["kernel_launches"])
                  for n in res["spmd"]]
        paths += [(f"mesh_pipe_{d}_r{r}", res["pipe"][d]["kernel_launches"])
                  for d in res["pipe"]]
        paths += [(f"mesh_zigzag_r{r}", res["zigzag"]["kernel_launches"])]
    return row, paths


#: K1's and K2/K3's CUDA kernels, one entry each in the ``kernels`` line:
#: (name, as the wrappers count it (``flash_attention.KERNELS``), source
#: under distkeras_tpu_torch/ops/csrc, the line of
#: distkeras_tpu/ops/pallas_attention.py it replaces)
# ---------------------------------------------------------------------------
# the continual loop, the scenario harness and the obs plane
# ---------------------------------------------------------------------------

#: the f32 card-vs-CPU twin of the continual loop: 2 intervals of 2
#: windows of 2 batches of 2 (the CPU runs the probe too)
CONTINUAL_TWIN = dict(intervals=2, batch=2, window=2, snapshot_every=2,
                      history=2, min_history=1, drift_interval=None)
CONTINUAL_TWIN_DEVICES = ("cuda", "cpu")
#: prompts served by the deploy target after each deploy and after the run
CONTINUAL_PROMPTS = (20, 40, 64, 100)
CONTINUAL_NEW = 8
SCENARIOS = ("smoke", "diurnal", "chaos")
#: the scenarios cut in depth to keep the run inside its time limit: the
#: diurnal trace's period 12 s -> 2 s (its rates as configured, a sixth
#: of its 1,458 arrivals; the probe's fleet drains about 4–6 a second)
#: and the chaos trace's 6 s -> 4 s (its rate and its kill at 2.5 s as
#: configured, two thirds of its arrivals).  On an H100 (700 W) whose
#: host ran the host-bound phases ~1.25x slower than another's, the
#: script took 1,121 s of its 1,200 with diurnal at 4 s (111.5 s) and
#: chaos at 6 s (49.1 s)
SCENARIO_TRACE_CUTS = {"diurnal": {"period_s": 2.0},
                       "chaos": {"duration_s": 4.0}}
#: the obs phase: the bf16 probe, 2 epochs of 4 steps of batch 16
OBS = dict(epochs=2, steps=4, batch=16)
#: each kernel the obs phase's bf16 Dh-64 training runs, by the symbol
#: of its CUDA function (what the trace names)
OBS_KERNEL_SYMBOLS = {"flash_fwd": "flash_fwd_wgmma_kernel",
                      "flash_bwd_dq": "flash_bwd_dq_wgmma_kernel",
                      "flash_bwd_dkv": "flash_bwd_dkv_wgmma_kernel"}


def _by_dtype(rows, dtype):
    return [r for r in rows if r[1] == dtype]


def _launch_total(rows, kernel_prefix=None):
    return sum(n for k, _, _, n in rows
               if kernel_prefix is None or k.startswith(kernel_prefix))


def _check_train_launches(rows, steps, what):
    """K1, K2 and K3 each launched exactly ``num_blocks`` x ``steps``."""
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        got = _launch_total(rows, k)
        check(got == LM["num_blocks"] * steps,
              f"{what}: {k}* launched {got} times for {steps} steps, "
              f"expected {LM['num_blocks'] * steps}")


def _variable_leaves(variables):
    """A JAX-shaped ``variables`` tree's leaves in the checkpoints' order."""
    from distkeras_tpu_torch.utils.tree import tree_leaves
    return tree_leaves(variables["params"]) + tree_leaves(variables["state"])


def _checkpoint_leaves(directory, step):
    """The leaves of checkpoint ``step`` in ``directory``, as written."""
    import numpy as np
    from distkeras_tpu_torch.utils import serde
    from distkeras_tpu_torch.utils.checkpoint import CheckpointManager
    with open(CheckpointManager(directory).path(step), "rb") as f:
        return [np.asarray(x) for x in
                serde.tree_from_bytes(f.read())["leaves"]]


def _served(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=CONTINUAL_NEW) for p in prompts]
    return [r.result(timeout=300) for r in reqs]


def _continual_run(torch, ckdir, intervals, drift_interval, deploy=True,
                   resume=False, offset=0):
    """One bounded continual run of the bf16 probe on the card
    (``bench.continual_parts``), its deploy target (with ``deploy``) a
    live f32 engine serving greedy requests from a thread while training
    runs; each deploy is held to its interval's checkpoint (bit for bit)
    and the engine's answers right after it to ``generate_tokens`` of a
    CPU model loaded with the deployed tree.  The run is traced
    (``torch.profiler``, CUDA) for the device's busy share; the launch
    counts are set to 0 just before it and read just after."""
    import threading
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from distkeras_tpu_torch import bench
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.obs import Registry
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    from distkeras_tpu_torch.utils.weights import load_jax_variables

    reg = Registry()
    trainer, engine, feed, c = bench.continual_parts(
        LM, checkpoint_dir=ckdir, registry=reg, deploy=deploy,
        drift_interval=drift_interval, intervals=intervals)
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, LM["vocab_size"], size=n)
               for n in CONTINUAL_PROMPTS]
    ref = zoo.gpt_lm(**LM).init(0, device="cpu")
    deploys = []
    promote = trainer._promote

    def checked_promote(host_vars):
        promote(host_vars)
        # the trainer records an exception here as a failed deploy and
        # trains on: a failed check is kept and raised after the run
        step = trainer.intervals_done - 1
        entry = {"interval": step}
        deploys.append(entry)
        t0 = time.perf_counter()
        try:
            mine = _variable_leaves(host_vars)
            entry["equals_checkpoint"] = _same_bits(
                mine, _checkpoint_leaves(ckdir, step)[:len(mine)])
            check(entry["equals_checkpoint"], f"interval {step}: the "
                  f"deployed tree is not its checkpoint's")
            load_jax_variables(ref, host_vars)
            entry["answers_mismatch_near_ties"] = _answers_match(
                torch, ref, prompts, _served(engine, prompts),
                [CONTINUAL_NEW] * len(prompts))
        except Exception as e:
            entry["failed"] = repr(e)[:1000]
        entry["check_s"] = time.perf_counter() - t0

    trainer._promote = checked_promote
    stop = threading.Event()
    traffic = {"served": 0}

    def serve_loop():
        i = 0
        while not stop.is_set():
            engine.submit(prompts[i % len(prompts)],
                          max_new_tokens=CONTINUAL_NEW).result(timeout=300)
            traffic["served"] += 1
            i += 1
            stop.wait(0.05)  # a steady light load beside the training

    thread = threading.Thread(target=serve_loop, daemon=True) \
        if deploy else None
    joins0 = reg.counter("serve.joins").value
    torch.cuda.synchronize()
    # the main path: counts set to 0 just before, read just after
    reset_launches()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if thread is not None:
                thread.start()
            trainer.run(feed(offset), intervals=intervals, resume=resume)
            stop.set()
            if thread is not None:
                thread.join(300)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        stop.set()
    rows = kernel_launches()
    failed = [d for d in deploys if "failed" in d]
    check(not failed, f"continual deploy checks failed: {failed}")
    t0 = time.perf_counter()
    busy = _busy_us(prof) / (wall * 1e6) if device_events(prof) else None
    if busy is None:
        _profiler_gap("continual", "not measured")
    return {"trainer": trainer, "engine": engine, "ref": ref, "feed": feed,
            "prompts": prompts, "deploys": deploys, "wall_s": wall,
            "busy": busy, "trace_read_s": time.perf_counter() - t0,
            "served_in_background": traffic["served"],
            "joins": int(reg.counter("serve.joins").value - joins0),
            "launches": rows, "registry": reg}


def _continual_crash(ckdir):
    """A crash inside interval 1 of a 3-interval run started with
    ``max_restarts=1``: the loop restarts from interval 0's checkpoint,
    its feed rebuilt at the recorded batch offset, and ends at interval
    3."""
    from distkeras_tpu_torch import bench
    trainer, _, feed, c = bench.continual_parts(
        LM, checkpoint_dir=ckdir, deploy=False, drift_interval=None,
        intervals=3)
    calls = {"n": 0}
    run_fn = trainer._run_fn

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == c["snapshot_every"] + 2:
            raise RuntimeError("injected continual crash")
        return run_fn(*a)

    trainer._run_fn = flaky
    offsets = []

    def factory(offset):
        offsets.append(offset)
        return feed(offset)

    trainer.start(feed(), intervals=3, max_restarts=1, feed_factory=factory)
    trainer._thread.join(600)
    check(not trainer._thread.is_alive(), "the restarted loop never ended")
    reg = trainer.registry
    per = c["snapshot_every"] * c["window"]
    row = {"restarts": reg.counter("continual.restarts").value,
           "offsets": offsets, "intervals_done": trainer.intervals_done,
           "intervals": reg.counter("continual.intervals").value}
    check(row["restarts"] == 1 and offsets == [per]
          and trainer.intervals_done == 3,
          f"continual restart did not resume at batch {per} and end at "
          f"interval 3: {row}")
    return row


def _continual_twin(torch):
    """The loop in f32 on the card and on the CPU from the same weights
    (``CONTINUAL_TWIN``): per-window losses within rtol 1e-4 (TF32 off)
    and the same gate decisions."""
    import numpy as np
    from distkeras_tpu_torch import bench
    out = {}
    for device in CONTINUAL_TWIN_DEVICES:
        trainer, _, feed, c = bench.continual_parts(
            LM, device=device, compute_dtype=None, deploy=False,
            **CONTINUAL_TWIN)
        losses = []
        run_fn = trainer._run_fn

        def record(*a, run_fn=run_fn, losses=losses):
            res = run_fn(*a)
            losses.append(res[2].detach().cpu().numpy().copy())
            return res

        trainer._run_fn = record
        trainer.run(feed(), intervals=c["intervals"])
        out[device] = (np.concatenate(losses),
                       [(e["kind"], e["deploy"])
                        for e in trainer.gate.history_log()])
    (lc, dc), (lh, dh) = (out[d] for d in CONTINUAL_TWIN_DEVICES)
    rel = float(np.max(np.abs(lc - lh) / np.abs(lh)))
    row = {"losses_card": lc.tolist(), "losses_cpu": lh.tolist(),
           "max_rel": rel, "decisions_card": dc, "decisions_cpu": dh}
    check(rel <= 1e-4, f"continual f32 twin: card and CPU losses differ "
          f"by {rel} (rtol 1e-4)")
    check(dc == dh, f"continual f32 twin: gate decisions differ {dc} "
          f"vs {dh}")
    return row


def _continual_row(run):
    """The bench row's numbers of one run, and its decisions."""
    from distkeras_tpu_torch import bench
    t = run["trainer"]
    snap = run["registry"].snapshot()
    s = bench.continual_summary(snap, run["wall_s"], t.intervals_done)
    s.update(steps=int(snap["continual.steps"]["value"]),
             wall_s=run["wall_s"], busy=run["busy"],
             trace_read_s=run["trace_read_s"],
             served_in_background=run["served_in_background"],
             engine_joins=run["joins"], deploy_checks=run["deploys"],
             verdict_log=[{k: e[k] for k in ("interval", "kind", "deploy",
                                             "deployed", "reason")}
                          for e in t.gate.history_log()])
    return s


def phase_continual(torch):
    """``ContinualTrainer`` on the card: the probe (``LM``, full width),
    bf16 compute, adam at lr 1e-2, over ``synthetic_lm_feed(4000, 512,
    16)`` with the JAX bench's cadence (``bench.CONTINUAL``: window 4,
    ``snapshot_every`` 4, history 3, ``min_history`` 2, 16 intervals, an
    abrupt drift at interval 10), checkpointing every interval, its
    deploy target a live f32 ``DecodeEngine`` of the probe on the same
    registry, serving greedy requests from a thread while training runs.
    If no interval before the drift deploys (the loss still trending), a
    warm run of 16 intervals without target or drift checkpoints, and a
    second run resumes from it (``resume=True``, the feed fast-forwarded
    to ``batches_consumed``) for 16 more with the engine and the drift at
    interval 26.  Checks: K1, K2 and K3 (bf16) each launched exactly 4 x
    the steps, K1 (f32) 4 x the engine's joins; ``jit.retraces == 0``; at
    least one deploy before the drift and a recorded dirty verdict from
    it on; each deployed tree equal to its checkpoint bit for bit and the
    engine's answers after each deploy equal to ``generate_tokens`` of a
    CPU model loaded with it; after the run, one more interval trained
    (resumed, no target) leaves the served weights the deployed ones; a
    crash with ``max_restarts=1`` resuming at the recorded offset; the
    f32 twin."""
    import shutil
    import tempfile
    from distkeras_tpu_torch import bench
    from distkeras_tpu_torch.utils import to_numpy_variables

    c0 = bench.CONTINUAL
    tmp = tempfile.mkdtemp(prefix="dkt_continual_")
    row = {"phase": "continual", "model": LM, "cadence": c0,
           "nvidia_smi": smi_line()}
    t_phase = time.perf_counter()
    try:
        drift = c0["drift_interval"]
        run = _continual_run(torch, os.path.join(tmp, "one"),
                             c0["intervals"], drift)
        log = run["trainer"].gate.history_log()
        if any(e["deployed"] and e["interval"] < drift for e in log):
            row["runs_needed"] = "one"
        else:
            # the probe still trends at the drift: warm it up first, then
            # resume (the exact-resume path) with the target and the drift
            run["engine"].stop()
            row["runs_needed"] = "two (warm, then resume)"
            row["first_attempt"] = _continual_row(run)
            emit({"phase": "continual_first_attempt",
                  **row["first_attempt"]})
            ck = os.path.join(tmp, "two")
            warm = _continual_run(torch, ck, c0["intervals"], None,
                                  deploy=False)
            row["warm"] = _continual_row(warm)
            emit({"phase": "continual_warm", **row["warm"]})
            drift += c0["intervals"]
            run = _continual_run(torch, ck, c0["intervals"], drift,
                                 resume=True,
                                 offset=warm["trainer"].batches_consumed)
            log = run["trainer"].gate.history_log()
            check(log and log[0]["interval"] == c0["intervals"],
                  f"the resumed run did not continue at interval "
                  f"{c0['intervals']}: {log[:1]}")
        t, engine = run["trainer"], run["engine"]
        try:
            s = _continual_row(run)
            rows = run["launches"]
            train_rows = _by_dtype(rows, "bfloat16")
            serve_rows = _by_dtype(rows, "float32")
            _check_train_launches(train_rows, s["steps"], "continual")
            check(_launch_total(serve_rows) == LM["num_blocks"] * run["joins"]
                  and _launch_total(serve_rows, "flash_bwd") == 0,
                  f"continual serving: {serve_rows} for {run['joins']} "
                  f"joins, expected K1 x {LM['num_blocks']} a join")
            check(s["jit_retraces"] == 0,
                  f"continual: jit.retraces = {s['jit_retraces']}")
            before = [e for e in log if e["deployed"]
                      and e["interval"] < drift]
            dirty = [e for e in log if e["interval"] >= drift
                     and e["reason"].startswith("drift-dirty")]
            check(before, f"continual: no deploy before the drift at "
                  f"interval {drift}: "
                  f"{[(e['kind'], e['reason']) for e in log]}")
            check(dirty, "continual: the drift produced no recorded "
                  "dirty rejection")
            check(all(e["kind"] == "stable" for e in log if e["deployed"]),
                  "continual: a deploy from a non-stable window")
            # one more trained interval, with no deploy target (and the
            # trainer's own promote): the served weights are still the
            # last deployed tree, and answer as it does
            deployed = _variable_leaves(t.deployed)
            t.deploy_to = None
            del t._promote
            t.run(run["feed"](t.batches_consumed), intervals=1,
                  resume=True)
            check(_same_bits(_variable_leaves(
                to_numpy_variables(engine.model)), deployed),
                "continual: the served weights moved after the deploy")
            check(not _same_bits(_variable_leaves(t.variables), deployed),
                  "continual: the interval after the run trained nothing")
            s["served_after_run_mismatch_near_ties"] = _answers_match(
                torch, run["ref"], run["prompts"],
                _served(engine, run["prompts"]),
                [CONTINUAL_NEW] * len(run["prompts"]))
        finally:
            engine.stop()
        s["deploys_before_drift"] = len(before)
        s["dirty_rejections_from_drift"] = len(dirty)
        s["drift_interval"] = drift
        row["run"] = s
        row["kernel_launches"] = {"continual_train": train_rows,
                                  "continual_serve": serve_rows}
        row["crash_restart"] = _continual_crash(os.path.join(tmp, "crash"))
        row["f32_twin"] = _continual_twin(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    return row


def _fleet_misses(servers) -> int:
    return int(sum(s.engine.registry.snapshot()["serve.prefix.misses"]
                   ["value"] for s in servers))


def phase_scenario(torch):
    """The scenario harness on the card (``bench.scenario_run``): the
    probe in f32 behind a ``ServeRouter`` fleet shaped by
    ``SCENARIO_FLEET`` (in-process engines of 1 slot, queue 12, 24 new
    tokens, prefix block 8 over a 16 MB cache, prefill buckets 16 and 48,
    fabric off) with ``OBS_BASELINE.json``'s alert rules on the router,
    under ``SCENARIO_TRACES``' ``smoke``, ``diurnal`` (autoscaled from 1
    of 3 engines; its period cut by ``SCENARIO_TRACE_CUTS``) and
    ``chaos`` (one engine stopped at 2.5 s).  After a trace has drained, the autoscaler keeps
    ticking on the idle fleet for up to ``bench.SCENARIO_IDLE_TAIL_S``.
    Checks, per scenario: dispatched == completed + rejected + timeouts
    (the runner raises otherwise), ``jit.retraces == 0``, K1 launched
    exactly 4 x the fleet's cold joins (``serve.prefix.misses``) and
    nothing else, the alert engine evaluated; in ``diurnal`` a scale-up
    and a scale-down (the events' times say whether it came in the trace
    or in the idle tail); in ``chaos`` one recovery.  Attainment, shed
    and scale events are recorded as they come, not gated."""
    from distkeras_tpu_torch import bench
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.obs import snapshot_quantile
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    from distkeras_tpu_torch.scenario import SLOTarget

    model = zoo.gpt_lm(**LM).init(seed=0)
    target = SLOTarget(**bench.SCENARIO_SLO)
    out = {"phase": "scenario", "model": LM,
           "fleet": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in bench.SCENARIO_FLEET.items()},
           "slo": bench.SCENARIO_SLO, "nvidia_smi": smi_line(),
           "scenarios": {}}
    paths = []
    for name in SCENARIOS:
        state = {}

        def before_traffic(servers, state=state):
            state["misses0"] = _fleet_misses(servers)
            # the main path: counts set to 0 just before the traffic
            reset_launches()

        t0 = time.perf_counter()
        row, part, servers = bench.scenario_run(
            name, model, target, before_traffic=before_traffic,
            trace=SCENARIO_TRACE_CUTS.get(name))
        launches = kernel_launches()
        misses = _fleet_misses(servers) - state["misses0"]
        retraces = sum(int(s.engine.registry.snapshot()["jit.retraces"]
                           ["value"]) for s in servers)
        check(_launch_total(launches) == LM["num_blocks"] * misses
              and _launch_total(launches, "flash_bwd") == 0,
              f"scenario {name}: {launches} for {misses} cold joins, "
              f"expected K1 x {LM['num_blocks']} a cold join")
        cnt = row["counts"]
        check(cnt["dispatched"] == cnt["completed"] + cnt["rejected"]
              + cnt["timeouts"], f"scenario {name}: accounting {cnt}")
        check(retraces == 0 and row["jit_retraces"] == 0,
              f"scenario {name}: jit.retraces = {retraces}")
        check(row["alert_rules_evaluated"],
              f"scenario {name}: the router's alert engine never ran")
        skew = part.get("scenario.dispatch_skew_seconds", {})
        srow = {
            "arrivals": row["arrivals"], "wall_s": row["wall_s"],
            "phase_s": time.perf_counter() - t0, "counts": cnt,
            "phases": [{k: p[k] for k in ("phase", "offered", "completed",
                                          "rejected", "attainment",
                                          "shed_rate", "goodput_tps",
                                          "ttft_p50", "e2e_p50",
                                          "e2e_p99")}
                       for p in row["phases"]],
            "goodput_tokens": cnt["goodput_tokens"],
            "dispatch_skew_p99_s": snapshot_quantile(skew, 0.99)
            if skew.get("count") else None,
            "scale_up": row["scale_up"], "scale_down": row["scale_down"],
            "scale_events": row["scale_events"],
            "idle_tail_s": row["idle_tail_s"], "shed": row["shed"],
            "recoveries": row["recoveries"],
            "recovery_s_p50": row["recovery_s_p50"],
            "alerts": row["alerts"], "cold_joins": misses,
            "kernel_launches": launches}
        out["scenarios"][name] = srow
        paths.append((f"scenario_{name}", launches))
        if name == "diurnal":
            # the reference's attainment signal keeps the last busy
            # seconds' attainment on an idle fleet, so a scale-down is
            # recorded as it comes, not asked for
            check(row["scale_up"] >= 1,
                  f"scenario diurnal: scale_up {row['scale_up']}, "
                  f"scale_down {row['scale_down']}: {srow}")
        if name == "chaos":
            n_rec = part.get("scenario.recovery_seconds", {}).get("count")
            check(n_rec == 1, f"scenario chaos: {n_rec} recoveries")
    emit(out)
    return out, paths


def phase_obs(torch):
    """The obs plane on the card: ``SingleTrainer`` trains the bf16 probe
    (``OBS``: 2 epochs of 4 steps of batch 16, sgd) with ``profile={
    "trace_dir": <tmp>, "step_split": True}``.  Checks: epoch 0's
    ``torch.profiler`` trace names K1's, K2's and K3's CUDA functions;
    ``step.host_seconds`` / ``step.device_seconds`` hold one observation
    per warm window call (epochs - 1: the cold call runs under its
    ``jit_compile`` span, as in the JAX trainers) and their sums stay
    within the training's wall time; ``write_chrome_trace`` of the run's
    records loads as JSON; ``to_prometheus_text`` of the registry parses
    line by line; K1-K3 launched exactly 4 x the steps."""
    import re
    import shutil
    import tempfile
    from distkeras_tpu_torch import SingleTrainer
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.obs import (Registry, to_prometheus_text,
                                         write_chrome_trace)
    from distkeras_tpu_torch.obs.profile import TRACE_FILE
    from distkeras_tpu_torch.ops.flash_attention import reset_launches

    tmp = tempfile.mkdtemp(prefix="dkt_obs_")
    try:
        t = SingleTrainer(zoo.gpt_lm(**LM), "sgd", SCE,
                          num_epoch=OBS["epochs"], batch_size=OBS["batch"],
                          learning_rate=0.1, compute_dtype="bfloat16",
                          profile={"trace_dir": os.path.join(tmp, "trace"),
                                   "step_split": True})
        reg = Registry()
        t.tracer.registry = reg
        ds = _lm_rows(OBS["steps"] * OBS["batch"])
        # the main path: counts set to 0 just before, read just after
        reset_launches()
        t.train(ds)
        launches = kernel_launches()
        steps = OBS["epochs"] * OBS["steps"]
        _check_train_launches(launches, steps, "obs")
        path = os.path.join(tmp, "trace", "epoch0", TRACE_FILE)
        with open(path) as f:
            text = f.read()
        json.loads(text)
        named = {k: sym in text for k, sym in OBS_KERNEL_SYMBOLS.items()}
        check(all(named.values()), f"obs: the epoch-0 trace names "
              f"{named}")
        snap = reg.snapshot()
        host, dev = snap["step.host_seconds"], snap["step.device_seconds"]
        warm = OBS["epochs"] - 1
        check(host["count"] == dev["count"] == warm,
              f"obs: step split holds {host['count']}/{dev['count']} "
              f"observations, expected {warm}")
        wall = t.get_training_time()
        check(host["sum"] + dev["sum"] <= wall,
              f"obs: host {host['sum']} + device {dev['sum']} s exceed "
              f"the training's {wall} s")
        doc = write_chrome_trace(t.metrics.records,
                                 os.path.join(tmp, "records.json"))
        with open(os.path.join(tmp, "records.json")) as f:
            check(json.load(f) == json.loads(json.dumps(doc)),
                  "obs: the exported trace does not load back")
        prom = to_prometheus_text(reg)
        line_re = re.compile(r"^(# TYPE [A-Za-z_:][A-Za-z0-9_:]* "
                             r"(counter|gauge|histogram)|[A-Za-z_:]"
                             r"[A-Za-z0-9_:]*(\{le=\"[^\"]+\"\})? "
                             r"[-+0-9.eE]+|[A-Za-z_:][A-Za-z0-9_:]*"
                             r"\{le=\"\+Inf\"\} [0-9]+)$")
        bad = [ln for ln in prom.splitlines() if not line_re.match(ln)]
        check(prom and not bad, f"obs: unparsable exposition lines {bad[:3]}")
        row = {"phase": "obs", "model": LM, **OBS,
               "trace_bytes": len(text), "trace_names": named,
               "step_host_s": host["sum"], "step_device_s": dev["sum"],
               "train_wall_s": wall,
               "epoch_seconds": [r["epoch_seconds"] for r in
                                 t.metrics.records if r["event"] == "epoch"],
               "chrome_events": len(doc["traceEvents"]),
               "prometheus_lines": len(prom.splitlines()),
               "kernel_launches": launches, "nvidia_smi": smi_line()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(row)
    return row


CUDA_KERNELS = (
    ("flash_fwd", "flash_fwd_sm90.cu", 83),
    ("flash_fwd_wgmma_wide", "flash_fwd_sm90.cu", 83),
    ("flash_fwd_f32", "flash_fwd_tf32_sm90.cu", 83),
    ("flash_fwd_cuda_cores", "flash_fwd.cu", 83),
    ("flash_fwd_f32_wide", "flash_fwd_tf32_sm90.cu", 83),
    ("flash_fwd_wgmma_past256", "flash_fwd_panels_sm90.cu", 83),
    ("flash_bwd_dq", "flash_bwd_sm90.cu", 169),
    ("flash_bwd_dq_wgmma_wide", "flash_bwd_sm90.cu", 169),
    ("flash_bwd_dq_f32", "flash_bwd_tf32_sm90.cu", 169),
    ("flash_bwd_dq_f32_wide", "flash_bwd_tf32_sm90.cu", 169),
    ("flash_bwd_dq_wgmma_past256", "flash_bwd_panels_sm90.cu", 169),
    ("flash_bwd_dq_f32_past256", "flash_bwd_tf32_panels_sm90.cu", 169),
    ("flash_bwd_dkv", "flash_bwd_sm90.cu", 200),
    ("flash_bwd_dkv_wgmma_wide", "flash_bwd_sm90.cu", 200),
    ("flash_bwd_dkv_f32", "flash_bwd_tf32_sm90.cu", 200),
    ("flash_bwd_dkv_f32_wide", "flash_bwd_tf32_sm90.cu", 200),
    ("flash_bwd_dkv_wgmma_past256", "flash_bwd_panels_sm90.cu", 200),
    ("flash_bwd_dkv_f32_past256", "flash_bwd_tf32_panels_sm90.cu", 200),
)


def kernels_line(k1, sl, tr, lm128, lm256, lm96, dist_kernels, past256,
                 bwd_rows, bwd_timed, later_paths=()):
    """The ``kernels`` line: one entry per CUDA kernel, with its launches
    on the main paths (each path's counts were set to 0 just before it ran
    and read just after, each launch counted under the kernel its C entry
    point reports it ran), its largest error against the plain version
    over every checked case it ran, and its headline timed row (the shape
    of its launches on its first training path) with the other timed
    shapes it ran."""
    from distkeras_tpu_torch.ops.flash_attention import KERNELS
    names = {n for ns in KERNELS.values() for n in ns if n is not None}
    check(names == {n for n, _, _ in CUDA_KERNELS},
          f"CUDA_KERNELS does not name the wrappers' kernels {names}")
    timing = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    # (path, [kernel, dtype, head dim, launches] rows): served traffic,
    # the bf16 probe, its f32 parity run, the Dh 128 model, distributed
    # ADAG, lm256's bf16 training, f32 parity and serving, lm96's bf16
    # training and f32 parity, and the Dh 320 op through autograd (the
    # one path of the K2 and K3 past Dh 256 in both dtypes); then
    # ``later_paths``, (path, rows) pairs of the later phases
    paths = (
        ("serve", sl["kernel_launches"]),
        ("train", tr["kernel_launches"]),
        ("train_f32", tr["parity_f32"]["kernel_launches"]),
        ("train_dh128", lm128["kernel_launches"]),
        ("dist_adag", dist_kernels),
        ("lm256_train", lm256["train"]["kernel_launches"]),
        ("lm256_train_f32", lm256["parity_f32"]["kernel_launches"]),
        ("lm256_serve", lm256["serve"]["kernel_launches"]),
        ("lm96_train", lm96["train"]["kernel_launches"]),
        ("lm96_train_f32", lm96["parity_f32"]["kernel_launches"]),
        ("past256", past256), *later_paths)
    kernels = []
    for name, src, line in CUDA_KERNELS:
        wrapper = next(fn for fn, ns in KERNELS.items() if name in ns)
        if wrapper == "dkt_flash_fwd":
            checked = [(r, ("max_abs_err",)) for r in k1
                       if r["kernel"] == name]
            timed = [{**{k: r[k] for k in ("dtype", "bh", "tq", "dh")},
                      **{k: r[k] for k in timing}}
                     for r in k1 if "ms" in r and r["kernel"] == name]
        else:
            key = "dq" if wrapper == "dkt_flash_bwd_dq" else "dkv"
            errs = ("dq_err",) if key == "dq" else ("dk_err", "dv_err")
            checked = [(r, errs) for r in bwd_rows
                       if r[f"{key}_kernel"] == name]
            # the plain version computes dQ, dK and dV in one call, and so
            # does SDPA's backward (K2 and K3 together)
            timed = [{"dtype": r["dtype"], "bh": r["bh"], "tq": r["t"],
                      "dh": r["dh"], "ms": r[f"{key}_ms"],
                      "tflops": r[f"{key}_tflops"],
                      "plain_ms": r["plain_ms"],
                      "library_ms": r["library_bwd_ms"],
                      "bound_ms": r[f"{key}_bound_ms"],
                      "bound_by": r[f"{key}_bound_by"]}
                     for r in bwd_timed if r[f"{key}_kernel"] == name]
        errs = [r[e] for r, es in checked for e in es]
        mine = {p: [(d, h, n) for k, d, h, n in rows if k == name]
                for p, rows in paths}
        by_path = {p: sum(n for _, _, n in m) for p, m in mine.items()}
        check(sum(by_path.values()) > 0,
              f"{name} was not launched on its main paths: {by_path}")
        # the headline: the dtype and head dim of the kernel's launches on
        # its first training path (serving runs at one request's B*H)
        main = next(m for p, m in mine.items() if m
                    and p not in ("serve", "lm256_serve"))
        dtype, dh, _ = max(main, key=lambda x: x[2])
        head = next(r for r in timed if (r["dtype"], r["dh"]) == (dtype, dh))
        entry = {"name": name, "route": "cuda",
                 "source": f"distkeras_tpu_torch/ops/csrc/{src}",
                 "replaces": f"distkeras_tpu/ops/pallas_attention.py:{line}",
                 "entry_point": wrapper,
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": max(errs), "checked_cases": len(errs),
                 "shape": {k: head[k] for k in ("dtype", "bh", "tq", "dh")},
                 **{k: head[k] for k in timing}, "timed": timed}
        kernels.append(entry)
    return kernels


def _wait_first_token(req, timeout):
    t_end = time.perf_counter() + timeout
    while req.first_token_t is None and time.perf_counter() < t_end:
        time.sleep(0.001)
    return req.first_token_t is not None


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import distkeras_tpu_torch  # noqa: F401  (fails here when run alone)
    seconds = {}
    t_start = time.perf_counter()

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        try:
            return phase(*args)
        finally:
            seconds[name] = time.perf_counter() - t0

    try:
        env = timed("env", phase_env, torch)
        timed("build", phase_build)
        k1 = timed("k1", phase_k1, torch)
        past256 = timed("past256", phase_past256, torch)
        import numpy as np
        from distkeras_tpu_torch.models import zoo
        model = zoo.gpt_lm(**LM).init(seed=0)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, LM["vocab_size"], size=n)
                   for n in PROMPT_LENS]
        sl = timed("slice", phase_slice, torch, model, prompts)
        timed("profile", phase_profile, torch, model, prompts)
        fleet = timed("fleet", phase_fleet, torch, model)
        # the same run under the port's race checker
        timed("fleet_racecheck", _under_racecheck, phase_fleet, torch, model)
        emit({"phase": "racecheck", "run": "fleet", "violations": 0,
              "seconds_with": seconds["fleet_racecheck"],
              "seconds_without": seconds["fleet"]})
        spec, spec_launches, spec_k1 = timed("spec", phase_spec, torch, model)
        beam, beam_k1 = timed("beam", phase_beam, torch, model)
        k1 = k1 + spec_k1 + beam_k1
        del model
        bwd_rows, bwd_timed = timed("k2k3", phase_k2k3, torch)
        tr = timed("train", phase_train, torch)
        lm128 = timed("lm128", phase_lm128, torch)
        lm256 = timed("lm256", phase_lm256, torch)
        lm96 = timed("lm96", phase_lm96, torch)
        timed("conv", phase_conv, torch)
        timed("models", phase_models, torch)
        dist_rows, _, dist_kernels = timed("dist", phase_dist, torch)
        _, config_paths = timed("config", phase_config, torch)
        ck = timed("ckpt", phase_ckpt, torch)
        timed("stream", phase_stream, torch)
        asy = timed("async", phase_async, torch, dist_rows)
        shard = timed("shard", phase_shard, torch, asy)
        _, moe_paths = timed("moe", phase_moe, torch)
        cont = timed("continual", phase_continual, torch)
        _, scenario_paths = timed("scenario", phase_scenario, torch)
        obs = timed("obs", phase_obs, torch)
        mesh_row, mesh_paths = timed("mesh", phase_mesh, torch)
        seconds.update({f"mesh.{k}": v for k, v in
                        mesh_row["seconds_by_run"]["rank0"].items()})
        later = list(config_paths)
        later += [("ckpt_straight", ck["kernel_launches"]),
                  ("ckpt_resumed", ck["kernel_launches_resumed"]),
                  ("ckpt_serve", ck["serve"]["kernel_launches"])]
        later += [(r["path"], r["kernel_launches"]) for r in asy]
        later += [("fleet", fleet["kernel_launches"]),
                  ("spec", spec_launches),
                  ("beam", beam["kernel_launches"])]
        later += [(r["path"], r["kernel_launches"]) for r in shard]
        later += moe_paths
        later += list(cont["kernel_launches"].items())
        later += scenario_paths
        later += [("obs_train", obs["kernel_launches"])]
        later += mesh_paths
        kernels = kernels_line(k1, sl, tr, lm128, lm256, lm96, dist_kernels,
                               past256, bwd_rows, bwd_timed, later)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        print(json.dumps({"phase_seconds": seconds,
                          "profiler_gaps": PROFILER_GAPS}), file=sys.stderr)
        return 1
    emit({"phase": "timing", "seconds": seconds,
          "total_s": time.perf_counter() - t_start,
          "profiler_gaps": PROFILER_GAPS})
    emit({"kernels": kernels})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(_mesh_rank(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
