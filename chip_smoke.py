#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distkeras_tpu_torch``) once on one card.

    python3 chip_smoke.py

Phases, one JSON line each:

1. ``env``    — torch/CUDA versions, the card, TF32 switched off.
2. ``build``  — the flash kernel, ``distkeras_tpu_torch/ops/csrc/
   flash_fwd.cu``, is built with nvcc for sm_90a if stale (seconds,
   registers, spills).
3. ``k1``     — the flash-attention forward kernel against its plain
   PyTorch version on the card, at the serving shapes and a few others
   (max abs error of O and lse; f32 <= 1e-5, bf16 <= 2e-2), with its
   device time from a ``torch.profiler`` trace, the plain version's,
   ``F.scaled_dot_product_attention``'s (a yardstick only: the port never
   calls it) and the least time the card could take (``bound_ms``).
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

Then the ``kernels`` line, the card's name and power limit as nvidia-smi
prints them, and as the last line ``{"ok": true, "device": {...}}``.  Any
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

#: H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor
#: cores, bf16 on them, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LM = dict(vocab_size=4000, dim=512, num_heads=8, num_blocks=4, seq_len=512,
          attention_impl="flash")
PROMPT_LENS = (20, 64, 100, 128, 200, 256, 300, 448)
MAX_NEW = (64, 16, 40, 24, 64, 32, 48, 64)


class CheckFailed(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: the durations of the kernels (and
    copies) it ran, from a ``torch.profiler`` CUDA trace, summed — the
    card's time without the host's launch overhead.  Fails the run when
    the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    check(us > 0, "the profiler trace holds no device time")
    return us / iters / 1e3


def flash_bound(bh, tq, tk, dh, causal, itemsize):
    """(bound_ms, bound_by) for one forward: operations over the peak of
    the input type, bytes (q/k/v read once, O and lse written once) over
    the memory rate — the larger of the two."""
    pairs = tq * (tq + 1) // 2 if causal else tq * tk
    flops = 4 * bh * dh * pairs
    nbytes = itemsize * bh * dh * (2 * tq + 2 * tk) + 4 * bh * tq
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


def phase_build():
    from distkeras_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    built = _kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built["built"],
          "ptxas": [ln.strip() for ln in built["log"].splitlines()
                    if "registers" in ln or "spill" in ln]})


def phase_k1(torch):
    """K1 against its plain version; returns the per-case rows."""
    import torch.nn.functional as F
    from distkeras_tpu_torch.ops.flash_attention import (flash_fwd_cuda,
                                                         flash_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for t in (64, 128, 256, 512):
        cases.append(("float32", True, 8, t, t, 64, True))
    for t in (64, 128, 256, 512):
        cases.append(("float32", False, 8, t, t, 64, False))
    for t in (64, 128, 256, 512):
        cases.append(("bfloat16", True, 8, t, t, 64, False))
    cases += [("float32", False, 8, 16, 48, 64, False),
              ("float32", True, 8, 100, 100, 64, False),
              ("float32", True, 8, 256, 256, 32, False)]
    rows = []
    for dtype_name, causal, bh, tq, tk, dh, timed in cases:
        dtype = getattr(torch, dtype_name)
        q = torch.randn((bh, tq, dh), generator=gen, device="cuda").to(dtype)
        k = torch.randn((bh, tk, dh), generator=gen, device="cuda").to(dtype)
        v = torch.randn((bh, tk, dh), generator=gen, device="cuda").to(dtype)
        scale = dh ** -0.5
        o, lse = flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_fwd_plain(q, k, v, causal, scale)
        err = max((o.float() - o_ref.float()).abs().max().item(),
                  (lse - lse_ref).abs().max().item())
        row = {"dtype": dtype_name, "causal": causal, "bh": bh, "tq": tq,
               "tk": tk, "dh": dh, "max_abs_err": err,
               "tol": TOL[dtype_name]}
        check(bool(torch.isfinite(o.float()).all()) and err <= row["tol"],
              f"K1 disagrees with its plain version: {row}")
        if timed:
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
        rows.append(row)
        emit({"phase": "k1", **row})
    return rows


def serve_traffic(model, prompts, window=None):
    """Warm a fresh engine up, then serve ``prompts`` (the first four at
    once, the rest once decoding is under way, so they join as the short
    requests free their slots, mid-decode for the others).  ``window``
    (a context manager) wraps the served traffic only.  Returns the
    registry, the requests, the wall seconds and the kernel's launches
    in warmup and in the served traffic."""
    import contextlib
    from distkeras_tpu_torch.obs import Registry
    from distkeras_tpu_torch.ops.flash_attention import flash_fwd_cuda
    from distkeras_tpu_torch.serve import DecodeEngine, ServeConfig

    registry = Registry()
    engine = DecodeEngine(model, ServeConfig(slots=4, max_new_tokens=64),
                          registry=registry)
    flash_fwd_cuda.launches = 0
    engine.warmup()
    warmup_launches = flash_fwd_cuda.launches
    # the main path: counts set to 0 just before, read just after
    flash_fwd_cuda.launches = 0
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
    return registry, reqs, wall, warmup_launches, flash_fwd_cuda.launches


def phase_slice(torch, model, prompts):
    """Serve 8 greedy requests on the card and hold them to the checks."""
    import numpy as np
    from distkeras_tpu_torch.models import generate_tokens, zoo
    from distkeras_tpu_torch.ops.flash_attention import flash_fwd_cuda

    registry, reqs, wall, warmup_launches, served_launches = serve_traffic(
        model, prompts)
    answers = [r.result() for r in reqs]
    snap = registry.snapshot()
    joins = int(snap["serve.joins"]["value"])

    # (a) each answer against the port's generate_tokens on the card
    flash_fwd_cuda.launches = 0
    mismatches = []
    for i, (p, m, got) in enumerate(zip(prompts, MAX_NEW, answers)):
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
           "mismatches": mismatches, "flash_vs_dense_logit_err": logit_err,
           "jit_retraces": retraces,
           "jit_compiles": int(snap["jit.compiles"]["value"])}
    emit(row)
    return row


def phase_profile(torch, model, prompts):
    """The same traffic again under a ``torch.profiler`` CUDA trace: the
    card's busy share of the served wall and where its time goes."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    _, reqs, wall, _, launches = serve_traffic(model, prompts, window=prof)
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    flash_us = sum(e.self_device_time_total for e in events
                   if "flash_fwd_kernel" in e.key)
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
        import numpy as np
        from distkeras_tpu_torch.models import zoo
        model = zoo.gpt_lm(**LM).init(seed=0)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, LM["vocab_size"], size=n)
                   for n in PROMPT_LENS]
        sl = phase_slice(torch, model, prompts)
        phase_profile(torch, model, prompts)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    head = next(r for r in k1 if r["dtype"] == "float32" and r["causal"]
                and r["tq"] == 512 and "ms" in r)
    f32 = [r["max_abs_err"] for r in k1 if r["dtype"] == "float32"]
    bf16 = [r["max_abs_err"] for r in k1 if r["dtype"] == "bfloat16"]
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "distkeras_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "distkeras_tpu/ops/pallas_attention.py:83",
        "replaces_kernel": "_fwd_kernel",
        "launches": sl["launches"]["served"],
        "max_abs_err": max(f32 + bf16), "max_err_f32": max(f32),
        "max_err_bf16": max(bf16),
        "shape": {k: head[k] for k in ("bh", "tq", "tk", "dh", "dtype",
                                       "causal")},
        # device time per call from the profiler (``ms`` and
        # ``kernel_ms`` name the same number)
        "ms": head["ms"], "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"]}]})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
