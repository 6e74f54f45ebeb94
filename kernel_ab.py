#!/usr/bin/env python3
"""Hold the flash kernels of this tree against those of another tree on
one card: each tree's kernels are built into their own library, the
same inputs go through both, and each (kernel, shape) gives the largest
difference of the two outputs, whether they agree within
``chip_smoke.GRAD_TOL`` of the dtype, and both device times, taken in
turns (other, this, this, other).

    mkdir -p _proof/parent                           # a git-ignored dir
    git archive <commit> | tar -x -C _proof/parent
    python3 kernel_ab.py _proof/parent [192,256]     # optional: these Dh

Each tree's build prints one line first: per kernel, its registers,
spill-store bytes and whether its wgmma products were serialized, as
ptxas reported them.  Both trees must have
``distkeras_tpu_torch/ops/_kernels.py`` with the C interface ``dkt_flash_fwd``, ``dkt_flash_bwd_dq`` and
``dkt_flash_bwd_dkv``.  A case the other tree's interface refuses (a
head dim it does not take) is timed in this tree alone, its line saying
``"other": "refused"``.  Prints one JSON line per case, then the card's
name and power limit; exits non-zero without a card.
"""

import ctypes
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

#: (kernel, dtype, B*H, T, Dh): the serving shapes of the f32 forward
#: (the probe's at Dh 64, and gpt_lm at dim 2048's joins at Dh 256), the
#: training shape and its Dh = 32 twin, the Dh-128 training shape (gpt_lm
#: at dim 1024), the Dh-256 one (dim 2048) with Dh 192 beside it, and Dh
#: 320 past the 256-wide tile (causal throughout)
CASES = ([("fwd", "float32", 8, t, 64) for t in (64, 128, 256, 512)]
         + [("fwd", "float32", 8, t, 256)
            for t in (20, 64, 100, 128, 256, 512)]
         + [(k, d, bh, 512, dh)
            for bh, dh in ((512, 64), (512, 32), (256, 128), (128, 192),
                           (128, 256), (128, 320))
            for d in ("bfloat16", "float32") for k in ("fwd", "dq", "dkv")])


def library(tree: str, tag: str) -> ctypes.CDLL:
    """Build (if stale) and load ``tree``'s kernels; prints a line of the
    registers and spill bytes ptxas reported for each kernel it built."""
    import chip_smoke
    path = os.path.join(tree, "distkeras_tpu_torch", "ops", "_kernels.py")
    spec = importlib.util.spec_from_file_location(f"_kernels_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    built = mod.build()
    print(json.dumps({"tree": tag, "ptxas": [
        [r["kernel"][-60:], r.get("registers"), r.get("spill_stores", 0),
         r["wgmma_serialized"]]
        for r in chip_smoke.ptxas_report(built["log"])]}), flush=True)
    return mod.library()


def run(torch, lib, kernel, q, k, v, lse, do, dvec):
    """One launch of ``kernel`` from ``lib``; returns its outputs."""
    bh, t, dh = q.shape
    code = 0 if q.dtype == torch.float32 else 1
    tail = (bh, t, t, dh, 1, ctypes.c_float(dh ** -0.5), code, 0,
            torch.cuda.current_stream().cuda_stream)
    if kernel == "fwd":
        outs = (torch.empty_like(q), torch.empty((bh, t), device="cuda"))
        err = lib.dkt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                *(x.data_ptr() for x in outs), *tail)
    else:
        outs = ((torch.empty_like(q),) if kernel == "dq"
                else (torch.empty_like(k), torch.empty_like(v)))
        fn = lib.dkt_flash_bwd_dq if kernel == "dq" else lib.dkt_flash_bwd_dkv
        err = fn(*(x.data_ptr() for x in (q, k, v, do, lse, dvec)),
                 *(x.data_ptr() for x in outs), *tail)
    if err:
        raise RuntimeError(f"{kernel}: CUDA error {err}")
    return outs


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) not in (2, 3):
        print("usage: kernel_ab.py OTHER_TREE [DH,DH,...] (on a machine "
              "with a card)", file=sys.stderr)
        return 1
    dims = ({int(d) for d in sys.argv[2].split(",")} if len(sys.argv) == 3
            else None)
    import chip_smoke
    from distkeras_tpu_torch.ops.flash_attention import flash_fwd_plain
    libs = {"other": library(sys.argv[1], "other"),
            "this": library(ROOT, "this")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kernel, dtype_name, bh, t, dh in CASES:
        if dims is not None and dh not in dims:
            continue
        dtype = getattr(torch, dtype_name)
        q, k, v, do = (torch.randn((bh, t, dh), generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        o, lse = flash_fwd_plain(q, k, v, True, dh ** -0.5)
        dvec = (do.float() * o.float()).sum(-1)
        args = (q, k, v, lse, do, dvec)
        outs = {"this": run(torch, libs["this"], kernel, *args)}
        try:
            outs["other"] = run(torch, libs["other"], kernel, *args)
        except RuntimeError:
            outs["other"] = None    # a case the other tree does not take
        ms = {n: [] for n in libs}
        for n in ("other", "this", "this", "other"):
            if outs[n] is not None:
                ms[n].append(chip_smoke.device_ms(
                    lambda: run(torch, libs[n], kernel, *args)))
        row = {"kernel": kernel, "dtype": dtype_name, "bh": bh, "t": t,
               "dh": dh, "causal": True, "this_ms": ms["this"]}
        if outs["other"] is None:
            row["other"] = "refused"
        else:
            pairs = list(zip(outs["this"], outs["other"]))
            row.update(max_abs_diff=max(
                (a.float() - b.float()).abs().max().item()
                for a, b in pairs),
                within_grad_tol=all(chip_smoke._within(
                    a, b, **chip_smoke.GRAD_TOL[dtype_name])
                    for a, b in pairs),
                other_ms=ms["other"],
                ratio=sum(ms["this"]) / sum(ms["other"]))
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, lse, dvec, args, outs
    print(chip_smoke.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
