"""Pipeline parallelism (GPipe) over the ``pp`` mesh axis — the port of
``distkeras_tpu.parallel.pipeline``.

S structurally identical stages sit one a rank along ``pp``; M
microbatches flow through them, each activation going on to the next
stage by ``mesh.ppermute`` (non-cyclic: stage 0 receives zeros).  The
schedule — fill, steady state, drain: M + S − 1 ticks — is the JAX
package's, tick for tick, as a Python loop where JAX scans: at every
tick every stage runs, stage 0 on microbatch t while any remain, and a
bubble tick computes on zeros (or on what arrived) and is masked out of
the result, so each rank launches its stage's work M + S − 1 times a
forward and as often in the backward (bubble fraction (S − 1)/(M + S −
1)).  The outputs are kept on the last stage and ``psum``ed to every
rank.

The masks are tensor ``where``s, never Python branches: every rank's
autograd graph then holds every tick's ``ppermute``, so the backward's
inverse permutations meet on every rank (a rank that skipped one would
leave its peer waiting).  Reverse-mode AD re-flows the activations'
cotangents through the inverse permutation, backward pipelining with no
hand-written schedule.  On a gloo group a CUDA activation's ``ppermute``
goes through the host (``mesh.GLOO_CUDA_DIRECT``), counted in
``mesh.collective_stats()``.

Stage contract: ``stage_fn(stage_params, x) -> y`` with ``y`` shaped as
``x`` (homogeneous blocks).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional, Sequence

import torch

from ..utils.tree import tree_leaves, tree_map
from .mesh import LocalSpec, Mesh, PartitionSpec, ppermute, psum, shard_map

Tree = Any
P = PartitionSpec


def stack_stage_params(stage_params: Sequence[Tree]) -> Tree:
    """Stack S per-stage trees into one tree with a leading (stage,)
    axis — the layout :func:`pipeline_apply_sharded` splits over
    ``pp``."""
    return tree_map(lambda *leaves: torch.stack(leaves), *stage_params)


def _sig(layer) -> tuple:
    return type(layer).__name__, repr(layer.config())


def find_stage_segment(layers: Sequence, n_stages: int,
                       input_shape: Optional[Sequence[int]] = None):
    """``(start, group_len)``: the longest run ``layers[start : start +
    n_stages * group_len]`` that splits into ``n_stages`` structurally
    identical groups (class and whole config equal, nested layers
    included), e.g. ``zoo.gpt_lm``'s repeated (attention, FF) blocks.
    Raises when the stack has none.

    ``n_stages == 1``: the model's repeated unit is located as a 2-stage
    split and extended over its run; a stack whose unit occurs once
    (``gpt_lm(num_blocks=1)``) takes the longest shape-preserving span,
    found by tracking ``out_shape`` from ``input_shape``."""
    sigs = [_sig(lyr) for lyr in layers]
    if n_stages == 1:
        try:
            a, g = find_stage_segment(layers, 2)
        except ValueError:
            if input_shape is None:
                raise ValueError(
                    "pp=1 with no repeated layer group: pass input_shape "
                    "so the stage segment can be chosen by shape "
                    "preservation, or raise num_blocks so the repeated "
                    "unit occurs at least twice")
            shapes = [tuple(input_shape)]
            for lyr in layers:
                shapes.append(tuple(lyr.out_shape(shapes[-1])))
            best = None
            for a in range(len(layers)):
                for end in range(len(layers), a, -1):
                    if shapes[a] == shapes[end]:
                        if best is None or end - a > best[1] - best[0]:
                            best = (a, end)
                        break
            if best is None:
                raise ValueError(
                    "pp=1 fallback found no shape-preserving span in "
                    "this stack; the model cannot pipeline")
            return best[0], best[1] - best[0]
        end = a + 2 * g
        while end + g <= len(layers) and sigs[end:end + g] == sigs[a:a + g]:
            end += g
        return a, end - a
    best = None
    for g in range(1, len(layers) // n_stages + 1):
        span = n_stages * g
        for a in range(0, len(layers) - span + 1):
            if all(sigs[a + i * g + j] == sigs[a + j]
                   for i in range(1, n_stages) for j in range(g)):
                if best is None or span > best[0]:
                    best = (span, a, g)
    if best is None:
        raise ValueError(
            f"no contiguous run of {n_stages} structurally identical "
            f"layer groups in this {len(layers)}-layer stack; pipeline "
            f"parallelism needs homogeneous stages (e.g. zoo.gpt_lm with "
            f"num_blocks divisible by the pp axis size)")
    return best[1], best[2]


def _stage_dtype(x: torch.Tensor, params: Tree) -> torch.dtype:
    """The activations' dtype: the input's promoted with the stage's
    floating parameters (bf16 tokens through f32 parameters → f32), so
    the schedule's buffers hold every tick's output."""
    dtype = x.dtype
    for p in tree_leaves(params):
        if p.is_floating_point():
            dtype = torch.promote_types(dtype, p.dtype)
    return dtype


def pipeline_apply(stage_fn: Callable, stage_params: Tree, x_mb, *,
                   axis_name: str = "pp", mesh: Optional[Mesh] = None):
    """The GPipe forward; call inside :func:`mesh.shard_map`.

    ``stage_params``: this rank's stage (leaves with a leading singleton
    stage axis).  ``x_mb``: the whole (M, mb, …) microbatch stack.
    Returns the (M, mb, …) outputs, the same on every rank of the axis
    (``psum``ed off the last stage)."""
    from .mesh import current_mesh
    mesh = current_mesh(mesh)
    n_stages = mesh.procs(axis_name)
    stage = mesh.coord(axis_name)
    params = tree_map(lambda p: p[0], stage_params)
    n_micro = x_mb.shape[0]
    dtype = _stage_dtype(x_mb, params)
    fwd = [(j, j + 1) for j in range(n_stages - 1)]  # stage 0 gets zeros
    device = x_mb.device
    first = torch.tensor(stage == 0, device=device)
    is_last = torch.tensor(stage == n_stages - 1, device=device)

    state = torch.zeros(x_mb.shape[1:], dtype=dtype, device=device)
    out = [torch.zeros_like(state) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t while any remain; the later stages
        # run on what the previous stage sent last tick
        inject = x_mb[min(t, n_micro - 1)].to(dtype)
        state = torch.where(first & (t < n_micro), inject, state)
        y = stage_fn(params, state).to(dtype)
        if y.shape != state.shape:
            raise ValueError(
                f"stage_fn must preserve the activation shape (homogeneous "
                f"stages): got {tuple(y.shape)} from {tuple(state.shape)}")
        # at tick t this stage holds microbatch m = t − stage
        m = t - stage
        mc = min(max(m, 0), n_micro - 1)
        out[mc] = torch.where(is_last & (0 <= m < n_micro), y, out[mc])
        state = ppermute(y, axis_name, fwd, mesh)
    return psum(torch.where(is_last, torch.stack(out), 0), axis_name, mesh)


def pipeline_apply_sharded(mesh: Mesh, stage_fn: Callable,
                           stacked_params: Tree, x, *,
                           num_microbatches: int, axis: str = "pp",
                           dp_axis: Optional[str] = None,
                           local_stages: bool = False):
    """Whole-array entry point: S = the ranks along ``axis`` stages over
    the pipeline.  ``stacked_params``: a leading (S, …) stage axis on
    every leaf (:func:`stack_stage_params`), each rank taking its own
    stage; with ``local_stages`` each rank passes only its own stage's
    (1, …) leaves (``mesh.LocalSpec``: a ``PipelineTrainer`` rank holds
    no other stage).  ``x``: (B, …) with B divisible by
    ``num_microbatches``; returns (B, …).

    ``dp_axis``: a second axis that splits each microbatch's batch dim —
    pp × dp: every dp replica runs the schedule on its slice of every
    microbatch, the stage parameters' gradients summed over ``dp`` at
    the boundary."""
    n_stages = mesh.procs(axis)
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible by "
                         f"num_microbatches {num_microbatches}")
    lead = tree_leaves(stacked_params)[0].shape[0]
    want = 1 if local_stages else n_stages
    if lead != want:
        raise ValueError(f"stacked_params lead dim {lead} != pipeline "
                         f"stages {want} (mesh axis {axis!r}"
                         f"{', local stages' if local_stages else ''})")
    mb = batch // num_microbatches
    if dp_axis is not None and mb % mesh.procs(dp_axis):
        raise ValueError(f"microbatch size {mb} not divisible by the "
                         f"{dp_axis!r} axis size {mesh.procs(dp_axis)}")
    x_mb = x.reshape(num_microbatches, mb, *x.shape[1:])
    param_spec = LocalSpec(axis) if local_stages else P(axis)
    data_spec = P(None, dp_axis) if dp_axis is not None else P()
    fn = shard_map(partial(pipeline_apply, stage_fn, axis_name=axis,
                           mesh=mesh),
                   mesh=mesh, in_specs=(param_spec, data_spec),
                   out_specs=data_spec)
    out = fn(stacked_params, x_mb)
    return out.reshape(batch, *out.shape[2:])
