#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distkeras_tpu_torch``) once on one card.

    python3 chip_smoke.py

Phases, one JSON line each:

1. ``env``    — torch/CUDA versions, the card, TF32 switched off.
2. ``build``  — the flash kernels, ``distkeras_tpu_torch/ops/csrc/
   flash_fwd.cu`` (K1's C interface; K1 on CUDA cores: f32 up to head
   dim 128 at grids too small for 64-row tiles, both dtypes past 256),
   ``flash_fwd_tf32_sm90.cu`` (K1 in f32 as 3xTF32 on mma.sync, up to
   head dim 256),
   ``flash_fwd_sm90.cu`` (K1 in bf16 up to head dim 256, on wgmma and
   TMA), ``flash_bwd.cu`` (the backward's C interface),
   ``flash_bwd_tf32_sm90.cu`` (K2, K3 in f32 up to 256, as 3xTF32 on
   mma.sync), ``flash_bwd_sm90.cu`` (K2, K3 in bf16 up to 256, on wgmma
   and TMA) and ``flash_bwd_wide.cu`` (K2, K3 past 256 on CUDA cores, in
   256-column panels; the ``_sm90`` files include ``sm90.cuh``, the
   ``_tf32_`` ones
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
   fabric's bytes, the busy share.  ``spec`` — 8 greedy requests of
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
   route, none under a CUDA-core kernel in training.
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

12. ``yaml_lm`` — configs/bench_all.yaml's flash LM (``YAML_LM_CONFIGS``:
   dim 128, 4 heads of Dh 32, bf16, 4 epochs of 32 steps at batch 64) as
   configured, then its ``quick`` variant (Dh 16, zero-padded to 32 by
   the bf16 kernels): K1, K2 and K3 launched exactly once per block per
   step, the loss falls.
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
   256-row shards for 4 epochs, ADAG at 8 workers from 128-row shards
   for 3), from shards written to a temporary directory: samples/s of
   the last epoch, stall seconds, the prefetch queue's mean depth over
   the run, peak memory; the busy share of the last epoch of the same
   configured run repeated under the profiler; the loss falls.  One epoch of the SingleTrainer config from RAM and from
   disk: parameters within rtol 2e-5, atol 2e-6.
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

``k1`` and ``k2k3`` also hold head dims 16, 48 and 96 (which bf16 K1
and K2/K3 run zero-padded to 32, 64 and 128, and the f32 K1 reads
unpadded; the f32 K1 also at Dh 5 and 127 on both its kernels), 136,
192, 200 and 256 (bf16 K1, K2 and K3 on wgmma, f32 K1, K2 and K3 as
3xTF32 at every grid; f32 also at 130, 193 and 255, read by 4-byte
loads) and 320 (CUDA cores, two 256-column panels), and
time 16 and 96 beside 32 and 128 at B*H 256 and 192, 256, 320 and 512
at B*H 128 (T 512).  Where an f32 kernel's output reads an error of
exactly 0 against the plain version, ``k2k3`` also shows the check is
live: a copy with its smallest value moved by 1e-4 must fail it.
``k1_tf32_control``: on Q and K with a common offset, the f32 K1 on
tensor cores (at Dh 192 and 256 its eight-warp kernel) is within 1e-5
of attention in float64 and one TF32 pass is not;
``k2_tf32_control`` and ``k3_tf32_control`` hold the f32 K2 and K3 at
Dh 192 and 256 so (dQ, dK and dV against K2 and K3 in float64, within
``GRAD_TOL``), and ``k2k3_exact_reading`` shows why the CUDA-core f32
K2 and K3 past Dh 256 can equal their plain version bit for bit.
``past256``: K1, K2 and K3 at Dh 320 in both
dtypes through the differentiable op (``flash_attention_lse`` and
autograd) against the plain versions, one launch each: the one path of
the CUDA-core K3, counted as the other paths are.

Then the ``kernels`` line (one entry per CUDA kernel: its launches on
the main paths, counted by the wrappers under the kernel each C entry
point reports it ran; its largest error against the plain version over
the checked cases it ran, every timed shape among them; its timed
rows), the card's name and power limit as nvidia-smi prints them,
and as the last line ``{"ok": true, "device": {...}}``.  Any
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
#: head dims the kernels run zero-padded to the next of HEAD_DIMS (bf16
#: K1, K2 and K3; the f32 K1 reads them unpadded)
PAD_HEAD_DIMS = (16, 48, 96)
#: head dims past 128: bf16 K1, K2 and K3 on wgmma (192- and 256-wide
#: tiles), f32 K1, K2 and K3 as 3xTF32 (192- and 256-wide tiles)
WIDE_HEAD_DIMS = (136, 192, 200, 256)
#: head dims past 128 that are not a multiple of 4: the f32 kernels read
#: their rows unpadded by 4-byte loads
WIDE_ODD_HEAD_DIMS = (130, 193, 255)
#: head dims past 256, which K1, K2 and K3 take on CUDA cores in
#: 256-column panels: checked at 320, timed at 320 and 512 (B*H 128)
PAST_HEAD_DIM = 320
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
#: the sync distributed configs of configs/bench_all.yaml:18-92 and the
#: SingleTrainer MLP/MNIST config (:6-16) that AveragingTrainer and
#: EnsembleTrainer run, as data (the card's machine has no yaml;
#: tests/test_torch_dist.py holds these against the file).  Unset keys
#: take the file's defaults (distkeras_tpu/config.py:40-42): loss
#: categorical_crossentropy, features "features", labels "label_onehot".
DIST_CONFIGS = {
    "SingleTrainer MLP/MNIST": dict(
        trainer="SingleTrainer", model="mlp_mnist", model_kwargs={},
        dataset="load_mnist", dataset_kwargs={"n_train": 16384}, onehot=10,
        trainer_kwargs={"num_epoch": 5, "batch_size": 128,
                        "learning_rate": 0.05}),
    "ADAG ConvNet/CIFAR-10 (auto-w)": dict(
        trainer="ADAG", model="convnet_cifar10", model_kwargs={},
        dataset="load_cifar10", dataset_kwargs={"n_train": 8192}, onehot=10,
        trainer_kwargs={"num_workers": "auto", "communication_window": 4,
                        "num_epoch": 5, "batch_size": 64,
                        "learning_rate": 0.05}),
    "DOWNPOUR ResNet-20/CIFAR-10 (auto-w)": dict(
        trainer="DOWNPOUR", model="resnet20", model_kwargs={},
        dataset="load_cifar10", dataset_kwargs={"n_train": 8192}, onehot=10,
        trainer_kwargs={"num_workers": "auto", "communication_window": 2,
                        "num_epoch": 3, "batch_size": 64,
                        "learning_rate": 0.01}),
    "AEASGD LSTM/IMDB (auto-w)": dict(
        trainer="AEASGD", model="lstm_imdb",
        model_kwargs={"vocab_size": 4000, "embed_dim": 64,
                      "lstm_units": 64, "seq_len": 200},
        dataset="load_imdb",
        dataset_kwargs={"n_train": 4096, "seq_len": 200,
                        "vocab_size": 4000}, onehot=None,
        trainer_kwargs={"num_workers": "auto", "communication_window": 4,
                        "rho": 1.0, "loss": "binary_crossentropy",
                        "label_col": "label", "num_epoch": 3,
                        "batch_size": 32, "learning_rate": 0.05}),
    "DynSGD ResNet-50/96px (auto-w)": dict(
        trainer="DynSGD", model="resnet50",
        model_kwargs={"num_classes": 100, "input_size": 96},
        dataset="load_imagenet_subset",
        dataset_kwargs={"n_train": 1024, "num_classes": 100,
                        "image_size": 96}, onehot=100,
        trainer_kwargs={"num_workers": "auto", "communication_window": 2,
                        "num_epoch": 3, "batch_size": 16,
                        "learning_rate": 0.005}),
}
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
#: configs/bench_all.yaml:97-117, the flash LM (Dh 32) and its ``quick``
#: variant (Dh 16, which the bf16 kernels run zero-padded to 32), as data
#: (tests/test_torch_dist.py holds them against the file)
YAML_LM_CONFIGS = {
    "GPT-LM flash T=256 (bf16)": dict(
        trainer="SingleTrainer", model="gpt_lm",
        model_kwargs={"vocab_size": 64, "dim": 128, "num_heads": 4,
                      "num_blocks": 2, "seq_len": 256,
                      "attention_impl": "flash"},
        dataset="load_lm_corpus",
        dataset_kwargs={"n_train": 2048, "seq_len": 256, "vocab_size": 64},
        onehot=None,
        trainer_kwargs={"loss": SCE, "label_col": "label", "num_epoch": 4,
                        "batch_size": 64, "learning_rate": 0.003,
                        "compute_dtype": "bfloat16"},
        quick={"model_kwargs": {"vocab_size": 64, "dim": 32,
                                "num_heads": 2, "num_blocks": 1,
                                "seq_len": 64, "attention_impl": "flash"},
               "dataset_kwargs": {"n_train": 256, "seq_len": 64,
                                  "vocab_size": 64},
               "trainer_kwargs": {"num_epoch": 1}}),
}
#: configs/bench_all.yaml:124-170, the two stream-from-disk configs, as
#: data: ``streaming`` is rows a shard, spilled by
#: ``ShardedFileDataset.write`` (distkeras_tpu/config.py:122-150)
STREAM_CONFIGS = {
    "ResNet-50/96px stream-from-disk": dict(
        trainer="SingleTrainer", model="resnet50",
        model_kwargs={"num_classes": 100, "input_size": 96},
        dataset="load_imagenet_subset",
        dataset_kwargs={"n_train": 1024, "num_classes": 100,
                        "image_size": 96}, onehot=100, streaming=256,
        trainer_kwargs={"num_epoch": 4, "batch_size": 16,
                        "learning_rate": 0.005,
                        "compute_dtype": "bfloat16"}),
    "ADAG ResNet-50/96px stream-from-disk (auto-w)": dict(
        trainer="ADAG", model="resnet50",
        model_kwargs={"num_classes": 100, "input_size": 96},
        dataset="load_imagenet_subset",
        dataset_kwargs={"n_train": 1024, "num_classes": 100,
                        "image_size": 96}, onehot=100, streaming=128,
        trainer_kwargs={"num_workers": "auto", "communication_window": 2,
                        "num_epoch": 3, "batch_size": 16,
                        "learning_rate": 0.005,
                        "compute_dtype": "bfloat16"}),
}
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


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: the durations of the kernels (and
    copies) it ran, from a ``torch.profiler`` CUDA trace, summed — the
    card's time without the host's launch overhead.  A trace that comes
    back without device events (seen once in a dozen sessions of one
    process) is taken again; fails the run when three traces in a row
    hold no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages())
        if us > 0:
            return us / iters / 1e3
    raise CheckFailed("the profiler trace holds no device time")


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
        name = re.search(r"flash_(fwd|bwd_dq|bwd_dkv)(_wgmma|_tf32|_wide)?"
                         r"_kernelI\w*?E(?=E)", mangled)
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
    # head dims between the instantiated ones, run zero-padded to 32, 64
    # and 128
    cases += [(dtype, causal, 8, t, t, dh, False)
              for dtype in ("bfloat16", "float32") for dh in PAD_HEAD_DIMS
              for causal in (True, False) for t in (100, 257)]
    cases += [(dtype, False, 8, 100, 257, dh, False)
              for dtype in ("bfloat16", "float32") for dh in PAD_HEAD_DIMS]
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
    # 256) and past 256 (CUDA cores, 256-column panels)
    cases += [(dtype, causal, 8, t, t, dh, False)
              for dtype in ("bfloat16", "float32")
              for dh in (*WIDE_HEAD_DIMS, PAST_HEAD_DIM)
              for causal in (True, False) for t in (100, 257)]
    cases += [(dtype, False, 8, 100, 257, dh, False)
              for dtype in ("bfloat16", "float32")
              for dh in (*WIDE_HEAD_DIMS, PAST_HEAD_DIM)]
    # the training shapes, checked and timed: the probe's (Dh 64), the
    # dim-1024 model's (Dh 128) and the dim-2048 model's (Dh 256, with
    # 192, 320 and 512 beside it), in both dtypes; at B*H 256 also Dh 16
    # and 96 beside 32
    cases += [(dtype, True, bh, TRAIN_T, TRAIN_T, dh, True)
              for bh, dh in ((TRAIN_BH, TRAIN_DH), (DH128_BH, 128),
                             (DH128_BH, 16), (DH128_BH, 32), (DH128_BH, 96),
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
    """The f32 K2 and K3 at head dims 129-256 are 3xTF32, not one TF32
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
                               (False, 64, 130, 256)):
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
        # (phase, output names, their slice of (dQ, dK, dV), kernel ran,
        # outputs, float64 witness, kernel wanted)
        for phase, names, cut, kernel, got, exact, want in (
                ("k2_tf32_control", ("dq",), slice(0, 1), dq_kernel, (dq,),
                 (dq_float64(torch, *args),), "flash_bwd_dq_f32_wide"),
                ("k3_tf32_control", ("dk", "dv"), slice(1, 3), dkv_kernel,
                 dkv, dkv_float64(torch, *args), "flash_bwd_dkv_f32_wide")):

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
          f"the f32 K2/K3 at Dh 129-256 are not held apart from one TF32 "
          f"pass: {rows}")


def _exact_reading(torch):
    """Why the CUDA-core f32 K2 and K3 (past Dh 256) can agree with their
    plain version bit for bit: the plain version's f32 products (cuBLAS)
    at these shapes against an in-order ``torch.addcmul`` chain over the
    contracted dim (those kernels' FMA loops), and ``s * scale - L``
    rounded twice (the plain version) against one fused ``addcmul`` (the
    kernels' contracted FMA) at the scales 1/sqrt(320) and 1/sqrt(512).
    (Up to Dh 256 every f32 kernel is 3xTF32, whose sums run in another
    order.)  Emits the shares of equal values; checks nothing."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    row = {"phase": "k2k3_exact_reading", "matmul_equals_fma_chain": {},
           "scaled_minus_l_equals_fma": {}}
    for dh in PAST_TIMED_HEAD_DIMS:
        a, b = (torch.randn((8, 512, dh), generator=gen, device="cuda")
                for _ in range(2))
        mm = a @ b.transpose(1, 2)
        chain = torch.zeros_like(mm)
        for d in range(dh):
            chain = torch.addcmul(chain, a[:, :, d, None], b[:, None, :, d])
        row["matmul_equals_fma_chain"][dh] = (mm == chain).float().mean() \
            .item()
        lse = torch.randn((8, 512, 1), generator=gen, device="cuda")
        scale = torch.full_like(mm, dh ** -0.5)
        row["scaled_minus_l_equals_fma"][dh] = (
            mm * dh ** -0.5 - lse == torch.addcmul(-lse, mm, scale)) \
            .float().mean().item()
    emit(row)


def phase_past256(torch):
    """K1, K2 and K3 at Dh ``PAST_HEAD_DIM`` (320: two 256-column panels
    on CUDA cores, as the reference's BlockSpecs span any head dim), in
    both dtypes, through the differentiable op a model calls
    (``flash_attention_lse``, then autograd with an lse cotangent),
    against the plain versions on the same inputs: one launch each, O and
    lse (f32 within 1e-5) and dQ, dK, dV within ``GRAD_TOL``.  Emits a
    row per dtype; returns the path's launches by kernel (counts set to 0
    just before, read just after)."""
    from distkeras_tpu_torch.ops.flash_attention import (
        _to_bh, flash_attention_lse, flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
        flash_bwd_plain, flash_fwd_cuda, flash_fwd_plain, reset_launches)
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
        out, lse = flash_attention_lse(q, k, v, True)
        grads = torch.autograd.grad((out, lse), (q, k, v), (g, g_lse))
        torch.cuda.synchronize()
        launches = [fn.launches - n for fn, n in zip(kernels, before)]
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
               "dv_err": _max_err(got[2], refs[2]), "tol": tol}
        emit(row)
        if dtype_name == "float32":
            fwd_ok = max(row["o_err"], row["lse_err"]) <= 1e-5
        else:
            fwd_ok = all(_within(a, r, **tol) for a, r in (
                (_to_bh(out), o_ref), (lse.reshape(b * h, t), lse_ref)))
        check(launches == [1, 1, 1] and fwd_ok and
              all(bool(torch.isfinite(x.float()).all()) and
                  _within(x, r, **tol) for x, r in zip(got, refs)),
              f"K1-K3 at head dim {dh} disagree with the plain versions "
              f"or launched other than once each: {row}")
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
    """Each served answer against the port's ``generate_tokens`` on the
    card (``news`` tokens a request, ``MAX_NEW`` by default): a mismatch
    is allowed only where the reference's top-2 logit gap is < 1e-4.
    Returns the mismatches."""
    import numpy as np
    from distkeras_tpu_torch.models import generate_tokens
    mismatches = []
    for i, (p, m, got) in enumerate(zip(prompts, news, answers)):
        ref = generate_tokens(model, p[None, :], m)[0, len(p):].cpu().numpy()
        check(got.shape == ref.shape, f"request {i}: {got.shape} tokens, "
              f"expected {ref.shape}")
        diff = np.nonzero(got != ref)[0]
        if diff.size:
            step = int(diff[0])
            seq = torch.as_tensor(np.concatenate([p, ref]))[None].cuda()
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
    flash_us = sum(e.self_device_time_total for e in events
                   if "flash_fwd_" in e.key)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    row = {"phase": "profile", "wall_s": wall, "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / wall,
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
        busy_us = _busy_us(prof)
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
        "device_busy_share": busy_us / 1e6 / prof_wall,
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
    there.  (An exact reading is no fault: cuBLAS's f32 products at these
    shapes sum in order with FMA, as the CUDA-core K2 and K3 past Dh 256
    do; PERF.md.)"""
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
    # head dims between the instantiated ones (zero-padded)
    cases += [(dtype, causal, 8, 257, 257, dh)
              for dtype in ("float32", "bfloat16") for dh in PAD_HEAD_DIMS
              for causal in (True, False)]
    cases += [(dtype, False, 8, 100, 256, dh)
              for dtype in ("float32", "bfloat16") for dh in PAD_HEAD_DIMS]
    # head dims past 128 (bf16 K2, K3 on wgmma and f32 K2, K3 as 3xTF32 up
    # to 256; f32 also at Dh % 4 != 0, read by 4-byte loads) and past 256
    # (CUDA cores, 256-column panels)
    cases += [(dtype, causal, 8, 257, 257, dh)
              for dtype in ("float32", "bfloat16")
              for dh in (*WIDE_HEAD_DIMS, PAST_HEAD_DIM)
              for causal in (True, False)]
    cases += [(dtype, False, 8, 100, 256, dh)
              for dtype in ("float32", "bfloat16")
              for dh in (*WIDE_HEAD_DIMS, PAST_HEAD_DIM)]
    cases += [("float32", causal, 8, 257, 257, dh) for dh in WIDE_ODD_HEAD_DIMS
              for causal in (True, False)]
    cases += [("float32", False, 8, 100, 256, dh) for dh in WIDE_ODD_HEAD_DIMS]
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
    _exact_reading(torch)

    # the training shapes, each checked as above and then timed: the
    # probe's (Dh 64) in both dtypes, then Dh 128 (bf16, the dim-1024
    # model's; f32 beside it), then at B*H 256 the padded Dh 16 and 96
    # beside Dh 32, then the dim-2048 model's Dh 256 with 192, 320 and
    # 512 beside it (B*H 128)
    timed = []
    for dtype_name, bh, dh in (("bfloat16", TRAIN_BH, TRAIN_DH),
                               ("float32", TRAIN_BH, TRAIN_DH),
                               ("bfloat16", DH128_BH, 128),
                               ("float32", DH128_BH, 128),
                               *((dtype, DH128_BH, dh)
                                 for dh in (16, 32, 96)
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
    epochs of ResNet-50."""
    from torch.autograd import DeviceType
    return [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()
            and not getattr(e, "is_hidden_event", lambda: False)()]


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
    from torch.profiler import ProfilerActivity, profile
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
    pt = trainer(2)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pt.train(ds)
        torch.cuda.synchronize()
    window_us, busy_us, by_name = last_epoch_on_device(prof)
    epoch_s = [r for r in pt.metrics.records
               if r["event"] == "epoch"][-1]["epoch_seconds"]
    share = {n: sum(us for name, us in by_name.items()
                    if names[n] in name) / busy_us for n in kernels}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
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
           "profiled_epoch": {
               # the second epoch's window on the trace's device timeline,
               # and the trainer's own CUDA-event seconds for it
               "window_s": window_us / 1e6, "epoch_s": epoch_s,
               "device_busy_s": busy_us / 1e6,
               "device_busy_share": busy_us / window_us,
               "kernel_share_of_device": share,
               "top_kernels": [{"name": name[:90], "device_ms": us / 1e3}
                               for name, us in top]}}
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
    from torch.profiler import ProfilerActivity, profile
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
    pt = bench.resnet20_trainer(2)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pt.train(ds)
        torch.cuda.synchronize()
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
           "profiled_run": {
               "epochs": 2, "epoch_seconds": window_us / 1e6,
               "device_busy_s": busy_us / 1e6,
               "device_busy_share": busy_us / window_us,
               "top_kernels": [{"name": n[:90], "device_ms": us / 1e3}
                               for n, us in top]},
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


def _with_quick(cfg):
    """A config with its ``quick`` overrides (distkeras_tpu/config.py:
    74-87: dicts merge, scalars replace)."""
    out = {k: v for k, v in cfg.items() if k != "quick"}
    for k, v in cfg.get("quick", {}).items():
        out[k] = {**out[k], **v} if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


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


def phase_yaml_lm(torch):
    """configs/bench_all.yaml's flash LM (Dh 32) as configured, then its
    ``quick`` variant (Dh 16, zero-padded to 32 by the bf16 kernels):
    losses finite, the configured run's falling, K1, K2 and K3 launched
    exactly once per block per step.  Returns the rows."""
    import numpy as np
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    rows = []
    for name, base in YAML_LM_CONFIGS.items():
        for variant, cfg in (("config", base), ("quick", _with_quick(base))):
            ds = _dist_data(cfg)
            t = _dist_trainer(cfg["trainer"], cfg)
            kw, mk = cfg["trainer_kwargs"], cfg["model_kwargs"]
            steps = ds.num_rows // kw["batch_size"]
            live = _reset_peak(torch)
            # this path: counts set to 0 just before, read just after
            reset_launches()
            t.train(ds)
            launches, by_kernel = _launch_counts(), kernel_launches()
            hist = t.get_averaged_history()
            check(all(bool(np.isfinite(h).all()) for h in t.get_history()),
                  f"{name} ({variant}): a training loss is not finite")
            if len(hist) > 1:
                check(hist[-1] < hist[0],
                      f"{name} ({variant}): the loss did not fall: {hist}")
            want = mk["num_blocks"] * steps * kw["num_epoch"]
            check(all(n == want for n in launches.values()),
                  f"{name} ({variant}): launches {launches} != {want} each")
            rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
            row = {"phase": "yaml_lm", "config": name, "variant": variant,
                   "model": mk, "head_dim": mk["dim"] // mk["num_heads"],
                   "steps_per_epoch": steps, "epochs": kw["num_epoch"],
                   "epoch_mean_loss": hist.tolist(),
                   "samples_per_s": rec["samples_per_sec"],
                   "step_ms": 1e3 * rec["epoch_seconds"] / steps,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                   "live_before_bytes": live,
                   "launches": launches, "kernel_launches": by_kernel}
            emit(row)
            rows.append(row)
    return rows


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
    """configs/bench_all.yaml's two stream-from-disk configs as
    configured (``STREAM_CONFIGS``), each reading shards written to a
    temporary directory from ``load_imagenet_subset``'s rows: samples/s
    of the last epoch, the stream's stall seconds, the prefetch queue's
    mean depth at a hand-over over the run, and peak memory; then the
    same configured run again under the profiler, from the same shards,
    for the busy share of its last epoch (and the time the trace takes
    to read); the loss falls.  Then one epoch of the
    SingleTrainer config from RAM and from disk on the same data order
    (cuDNN deterministic): parameters within rtol 2e-5, atol 2e-6
    (tests/test_streaming_data.py:114-131), bit-identical expected."""
    import shutil
    import tempfile
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
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
            t, wall, peak, counters = _stream_run(torch, cfg, src)
            hist = t.get_averaged_history()
            check(all(bool(np.isfinite(h).all()) for h in t.get_history()),
                  f"{name}: a training loss is not finite")
            check(hist[-1] < hist[0], f"{name}: the loss did not fall: "
                  f"{hist}")
            check(counters["stream.producer_leaks"] == 0,
                  f"{name}: a prefetch thread outlived its join")
            rec = [r for r in t.metrics.records if r["event"] == "epoch"][-1]
            # the busy share: the configured run again, under the profiler
            pt = _dist_trainer(cfg["trainer"], cfg)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                pt.train(src)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            window_us, busy_us, _ = last_epoch_on_device(prof, len(hist))
            read_s = time.perf_counter() - t0
            prec = [r for r in pt.metrics.records
                    if r["event"] == "epoch"][-1]
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
                   "profiled": {"last_epoch_s": prec["epoch_seconds"],
                                "samples_per_s": prec["samples_per_sec"],
                                "window_s": window_us / 1e6,
                                "device_busy_share": busy_us / window_us,
                                "trace_read_s": read_s}}
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
    LM (``YAML_LM_CONFIGS``: Dh 32, bf16, batch 64): each child holds its
    own CUDA context and loads the kernel library the parent built; the
    children's launches fold into the parent's counts."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import zoo
    cfg = next(iter(YAML_LM_CONFIGS.values()))
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


#: K1's and K2/K3's CUDA kernels, one entry each in the ``kernels`` line:
#: (name, as the wrappers count it (``flash_attention.KERNELS``), source
#: under distkeras_tpu_torch/ops/csrc, the line of
#: distkeras_tpu/ops/pallas_attention.py it replaces)
CUDA_KERNELS = (
    ("flash_fwd", "flash_fwd_sm90.cu", 83),
    ("flash_fwd_wgmma_wide", "flash_fwd_sm90.cu", 83),
    ("flash_fwd_f32", "flash_fwd_tf32_sm90.cu", 83),
    ("flash_fwd_cuda_cores", "flash_fwd.cu", 83),
    ("flash_fwd_f32_wide", "flash_fwd_tf32_sm90.cu", 83),
    ("flash_bwd_dq", "flash_bwd_sm90.cu", 169),
    ("flash_bwd_dq_wgmma_wide", "flash_bwd_sm90.cu", 169),
    ("flash_bwd_dq_f32", "flash_bwd_tf32_sm90.cu", 169),
    ("flash_bwd_dq_wide", "flash_bwd_wide.cu", 169),
    ("flash_bwd_dq_f32_wide", "flash_bwd_tf32_sm90.cu", 169),
    ("flash_bwd_dkv", "flash_bwd_sm90.cu", 200),
    ("flash_bwd_dkv_wgmma_wide", "flash_bwd_sm90.cu", 200),
    ("flash_bwd_dkv_f32", "flash_bwd_tf32_sm90.cu", 200),
    ("flash_bwd_dkv_f32_wide", "flash_bwd_tf32_sm90.cu", 200),
    ("flash_bwd_dkv_wide", "flash_bwd_wide.cu", 200),
)


def kernels_line(k1, sl, tr, lm128, lm256, dist_kernels, past256, bwd_rows,
                 bwd_timed, later_paths=()):
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
    # ADAG, lm256's bf16 training, f32 parity and serving, and the Dh 320
    # op through autograd (the CUDA-core K3's one path); then
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
    try:
        env = phase_env(torch)
        phase_build()
        k1 = phase_k1(torch)
        past256 = phase_past256(torch)
        import numpy as np
        from distkeras_tpu_torch.models import zoo
        model = zoo.gpt_lm(**LM).init(seed=0)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, LM["vocab_size"], size=n)
                   for n in PROMPT_LENS]
        sl = phase_slice(torch, model, prompts)
        phase_profile(torch, model, prompts)
        fleet = phase_fleet(torch, model)
        spec, spec_launches, spec_k1 = phase_spec(torch, model)
        beam, beam_k1 = phase_beam(torch, model)
        k1 = k1 + spec_k1 + beam_k1
        del model
        bwd_rows, bwd_timed = phase_k2k3(torch)
        tr = phase_train(torch)
        lm128 = phase_lm128(torch)
        lm256 = phase_lm256(torch)
        phase_conv(torch)
        phase_models(torch)
        dist_rows, _, dist_kernels = phase_dist(torch)
        yl = phase_yaml_lm(torch)
        ck = phase_ckpt(torch)
        phase_stream(torch)
        asy = phase_async(torch, dist_rows)
        shard = phase_shard(torch, asy)
        _, moe_paths = phase_moe(torch)
        later = [(f"yaml_lm_{r['variant']}", r["kernel_launches"])
                 for r in yl]
        later += [("ckpt_straight", ck["kernel_launches"]),
                  ("ckpt_resumed", ck["kernel_launches_resumed"]),
                  ("ckpt_serve", ck["serve"]["kernel_launches"])]
        later += [(r["path"], r["kernel_launches"]) for r in asy]
        later += [("fleet", fleet["kernel_launches"]),
                  ("spec", spec_launches),
                  ("beam", beam["kernel_launches"])]
        later += [(r["path"], r["kernel_launches"]) for r in shard]
        later += moe_paths
        kernels = kernels_line(k1, sl, tr, lm128, lm256, dist_kernels,
                               past256, bwd_rows, bwd_timed, later)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    emit({"kernels": kernels})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
