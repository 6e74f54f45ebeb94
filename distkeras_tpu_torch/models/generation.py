"""Autoregressive generation for causal LMs (the port of
``distkeras_tpu.models.generation``: ``generate_tokens``, ``generate_beam``
and the per-row sampling and decode-window helpers the serving engine
uses).

Two decode strategies, as in the JAX package:

* **KV-cached** (default when the model supports it): one batched
  prefill over the whole (B, T) buffer (``Layer.apply_prefill``) fills
  every layer's K/V, then one ``apply_decode`` per generated token.
* **Full-context recompute** (``use_cache=False``): rerun the forward on
  the whole buffer each step.

PyTorch runs eagerly, so the JAX package's one compiled ``lax.scan`` is a
Python loop here.  Caches and the token buffer are updated in place.

Beam search is deterministic: its tokens equal the JAX package's and its
scores agree within float rounding.  Sampling draws come from an
explicit ``torch.Generator`` seeded with
``seed``; they are not ``jax.random``'s draws, so sampled continuations
differ from the JAX package's while their distributions
(``rowwise_dist``) and every greedy continuation agree.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import DeviceLike, default_device
from ..utils.tree import tree_leaves, tree_map
from .layers import Layer

_NEG = -1e30


def _model_cache(model, batch):
    """The model's decode cache, or None when the cached path is
    unsupported: no ``init_cache`` protocol, a mesh-attached layer, a
    time-mixing layer without its own decode rule, or nothing that
    caches."""
    init = getattr(model.layer, "init_cache", None)
    if init is None:
        return None
    for lyr in model.iter_layers():
        if getattr(lyr, "mesh", None) is not None:
            return None
        if getattr(lyr, "time_mixing", False) and \
                type(lyr).apply_decode is Layer.apply_decode:
            return None
    cache = init(batch, model.input_shape)
    return cache if tree_leaves(cache) else None


def _write_at(buf, tok, pos, t, keep=None):
    """Write ``tok`` (B,) into ``buf[:, pos]`` in place and return ``buf``.
    ``pos`` is an int or a (B,) tensor; positions >= ``t`` and rows where
    ``keep`` (B,) bool is False are left alone (the JAX package's one-hot
    write semantics), with no host sync."""
    if not torch.is_tensor(pos):
        if pos < t:
            buf[:, pos] = tok if keep is None else torch.where(
                keep, tok.to(buf.dtype), buf[:, pos])
        return buf
    rows = torch.arange(buf.shape[0], device=buf.device)
    ok = pos < t if keep is None else keep & (pos < t)
    p = pos.clamp(max=t - 1)
    buf[rows, p] = torch.where(ok, tok.to(buf.dtype), buf[rows, p])
    return buf


def _categorical(gen, logits):
    """One draw per row from softmax(logits) (Gumbel-max)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _filter_logits(logits, top_k, top_p):
    """top-k / nucleus (top-p) filtering with batch-wide constants."""
    if top_k is not None:
        kth = torch.topk(logits, int(top_k), dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, _NEG)
    if top_p is not None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        thresh = torch.where(keep, sorted_desc, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, _NEG)
    return logits


def filter_logits_rowwise(logits, top_k, top_p):
    """Per-row top-k / nucleus filtering with (B,) parameters:
    ``top_k[r] == 0`` disables top-k for row r, ``top_p[r] >= 1``
    disables nucleus filtering.  ``logits`` is (B, V)."""
    v = logits.shape[-1]
    top_k = torch.as_tensor(top_k, dtype=torch.long, device=logits.device)
    top_p = torch.as_tensor(top_p, dtype=logits.dtype, device=logits.device)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1, (top_k - 1).clamp(0, v - 1)[:, None])
    logits = logits.masked_fill((top_k > 0)[:, None] & (logits < kth), _NEG)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    thresh = torch.where(keep, sorted_desc, torch.inf).amin(dim=-1,
                                                           keepdim=True)
    return logits.masked_fill((top_p < 1.0)[:, None] & (logits < thresh),
                              _NEG)


def _tempered(logits, temperature):
    temperature = torch.as_tensor(temperature, dtype=logits.dtype,
                                  device=logits.device)
    greedy = temperature <= 0.0
    return logits / torch.where(greedy, 1.0, temperature)[:, None], greedy


def rowwise_dist(logits, temperature, top_k, top_p):
    """The per-row sampling distribution: softmax of the tempered,
    filtered logits.  Returns (B, V) probabilities."""
    scaled, _ = _tempered(logits, temperature)
    return torch.softmax(filter_logits_rowwise(scaled, top_k, top_p), dim=-1)


def sample_rowwise(gen, logits, temperature, top_k, top_p):
    """One next-token draw per row under per-row sampling params: rows at
    ``temperature <= 0`` take the EXACT argmax, others sample from the
    filtered, tempered distribution with generator ``gen``.  Returns
    int64 (B,)."""
    scaled, greedy = _tempered(logits, temperature)
    sampled = _categorical(gen, filter_logits_rowwise(scaled, top_k, top_p))
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)


def decode_window(layer, tokens, cache, start, limit=None):
    """Feed ``tokens`` (B, K) through ``layer.apply_decode`` at positions
    ``start + i`` (``start`` int or (B,) tensor), returning the
    per-position logits (B, K, V) and the cache.  ``limit`` (the model's
    seq_len) clamps every position to ``limit - 1``."""
    outs = []
    for i in range(int(tokens.shape[1])):
        pos = start + i
        if limit is not None:
            pos = pos.clamp(max=limit - 1) if torch.is_tensor(pos) \
                else min(pos, limit - 1)
        logits, cache = layer.apply_decode(tokens[:, i], cache, pos)
        outs.append(logits)
    return torch.stack(outs, dim=1), cache


@torch.no_grad()
def generate_tokens(model, prompt, num_steps: int,
                    temperature: float = 0.0, seed: int = 0,
                    use_cache=None, top_k=None, top_p=None, eos_id=None,
                    prompt_lengths=None, device: DeviceLike = None):
    """Generate ``num_steps`` tokens after ``prompt`` (B, P) ints.

    Same contract as the JAX package's ``generate_tokens``: greedy at
    ``temperature == 0``; ``top_k``/``top_p`` filter sampling; ``eos_id``
    freezes a row once it emits EOS; ``prompt_lengths`` (B,) gives the
    true lengths of RIGHT-padded ragged prompts; ``use_cache`` None
    picks the KV-cached path when the model supports it.  ``device``
    (default: the card) must be where the model lives.  Returns an int64
    (B, P + num_steps) tensor on ``device``."""
    device = default_device(device)
    if model.device != device:
        raise ValueError(f"the model lives on {model.device}, not {device}")
    t = int(model.input_shape[0])
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long)
    if prompt.ndim != 2:
        raise ValueError(f"prompt must be (B, P), got {tuple(prompt.shape)}")
    b, p = prompt.shape
    num_steps = int(num_steps)
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    if top_k is not None and int(top_k) < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < float(top_p) <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if not 1 <= p <= t - num_steps:
        raise ValueError(f"prompt length {p} + {num_steps} steps exceeds "
                         f"the model's seq_len {t}")
    prompt = prompt.to(device)
    if num_steps == 0:
        return prompt

    lens = None
    if prompt_lengths is not None:
        lengths = np.asarray(prompt_lengths, np.int64)
        if lengths.shape != (b,):
            raise ValueError(f"prompt_lengths shape {lengths.shape} != "
                             f"({b},)")
        if lengths.min() < 1 or lengths.max() > p:
            raise ValueError(f"prompt_lengths must lie in [1, {p}]")
        if int(lengths.max()) + num_steps > t:
            raise ValueError(
                f"longest prompt {int(lengths.max())} + {num_steps} steps "
                f"exceeds the model's seq_len {t}")
        if (lengths != lengths.max()).any() or int(lengths.max()) != p:
            lens = torch.as_tensor(lengths).to(device)

    cache = None
    if use_cache in (None, True):
        cache = _model_cache(model, b)
    if use_cache is True and cache is None:
        raise ValueError(
            "use_cache=True but the cached decode path is unsupported "
            "here: the model has no caching layer / init_cache protocol, "
            "a mesh-attached attention layer, or a time-mixing layer "
            "without a decode rule; use use_cache=False")

    buf = torch.zeros((b, t), dtype=torch.long, device=device)
    buf[:, :p] = prompt
    gen = torch.Generator(device=device).manual_seed(int(seed))
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    rows = torch.arange(b, device=device)

    def sample(next_logits, done):
        if temperature > 0.0:
            nxt = _categorical(gen, _filter_logits(
                next_logits / temperature, top_k, top_p))
        else:
            nxt = torch.argmax(next_logits, dim=-1)
        if eos_id is not None:
            # masked continue: finished rows repeat EOS; the done flag
            # latches on the first EOS emission
            nxt = torch.where(done, int(eos_id), nxt)
            done = done | (nxt == int(eos_id))
        return nxt, done

    if cache is not None:
        y, cache = model.layer.apply_prefill(buf, cache)
        logits = y[:, p - 1] if lens is None else y[rows, lens - 1]
        for i in range(num_steps - 1):
            nxt, done = sample(logits, done)
            pos = (p + i) if lens is None else (lens + i)
            _write_at(buf, nxt, pos, t)
            logits, cache = model.layer.apply_decode(nxt, cache, pos)
        last, _ = sample(logits, done)
        _write_at(buf, last, (p - 1 + num_steps) if lens is None
                  else (lens - 1 + num_steps), t)
    else:
        base = torch.full((b,), p, device=device) if lens is None else lens
        for i in range(num_steps):
            pos = base - 1 + i
            nxt, done = sample(model(buf)[rows, pos], done)
            _write_at(buf, nxt, pos + 1, t)
    return buf[:, :p + num_steps]


@torch.no_grad()
def generate_beam(model, prompt, num_steps: int, num_beams: int = 4,
                  eos_id=None, length_penalty: float = 0.0,
                  use_cache=None, return_scores: bool = False,
                  prompt_lengths=None, device: DeviceLike = None):
    """Deterministic beam search: ``num_beams`` hypotheses per row, the
    highest-(length-normalized)-log-probability continuation returned.

    Beams flatten into the batch dimension (B·K rows), so both decode
    strategies work unchanged — the KV cache is per-row and beam
    reindexing is a batch gather of every cache leaf.  ``eos_id`` freezes
    a hypothesis at its first EOS (its score stops accumulating);
    ``length_penalty`` α divides final scores by (generated length)^α.
    ``prompt_lengths``: (B,) true lengths of RIGHT-padded ragged prompts —
    each row's hypotheses extend from its own length.  The cached path
    prefills the B·K rows in one ``apply_prefill`` (on the card, one
    flash-attention launch per attention layer).  ``device`` (default:
    the card) must be where the model lives.  Returns an int64
    (B, P + num_steps) tensor on ``device``, plus the (B,) float32 best
    scores when ``return_scores``."""
    device = default_device(device)
    if model.device != device:
        raise ValueError(f"the model lives on {model.device}, not {device}")
    t = int(model.input_shape[0])
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long)
    if prompt.ndim != 2:
        raise ValueError(f"prompt must be (B, P), got {tuple(prompt.shape)}")
    b, p = prompt.shape
    num_steps = int(num_steps)
    k_beams = int(num_beams)
    if k_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    if not 1 <= p <= t - num_steps:
        raise ValueError(f"prompt length {p} + {num_steps} steps exceeds "
                         f"the model's seq_len {t}")
    lens = None
    if prompt_lengths is not None:
        lengths = np.asarray(prompt_lengths, np.int64)
        if lengths.shape != (b,):
            raise ValueError(f"prompt_lengths shape {lengths.shape} != "
                             f"({b},)")
        if lengths.min() < 1 or lengths.max() > p:
            raise ValueError(f"prompt_lengths must lie in [1, {p}]")
        if int(lengths.max()) + num_steps > t:
            raise ValueError(
                f"longest prompt {int(lengths.max())} + {num_steps} steps "
                f"exceeds the model's seq_len {t}")
        if (lengths != lengths.max()).any() or int(lengths.max()) != p:
            # lens is constant within a row's beam group, so beam
            # regathering never changes it
            lens = torch.as_tensor(lengths).repeat_interleave(
                k_beams).to(device)
    prompt = prompt.to(device)
    if num_steps == 0:
        return (prompt, torch.zeros((b,), dtype=torch.float32,
                                    device=device)) \
            if return_scores else prompt

    bk = b * k_beams
    cache = _model_cache(model, bk) if use_cache in (None, True) else None
    if use_cache is True and cache is None:
        raise ValueError(
            "use_cache=True but the cached decode path is unsupported "
            "here (see generate_tokens); use use_cache=False")

    buf = torch.zeros((bk, t), dtype=torch.long, device=device)
    buf[:, :p] = prompt.repeat_interleave(k_beams, dim=0)
    rows_all = torch.arange(bk, device=device)
    group = torch.arange(b, device=device)[:, None] * k_beams

    def expand(scores, done, gen_len, logits_prev):
        """One selection: (B·K, V) logits → per-row top-K of the K·V
        continuations → (scores, done, gen_len, tokens, source rows)."""
        logp = torch.log_softmax(logits_prev.float(), dim=-1)
        v = logp.shape[-1]
        if eos_id is not None:
            # finished beams may only "continue" with EOS at no cost: the
            # hypothesis is frozen but stays selectable
            frozen = torch.full_like(logp, _NEG)
            frozen[:, int(eos_id)] = 0.0
            logp = torch.where(done[:, None], frozen, logp)
        total = (scores[:, None] + logp).reshape(b, k_beams * v)
        # a stable descending sort: ties keep the lower index first, as
        # lax.top_k orders them
        idx = torch.sort(total, dim=-1, descending=True,
                         stable=True).indices[:, :k_beams]
        top = torch.gather(total, 1, idx)
        rows = (group + idx // v).reshape(-1)
        tok = (idx % v).reshape(-1)
        new_done = done[rows]
        new_len = gen_len[rows] + (~new_done).to(gen_len.dtype)
        if eos_id is not None:
            new_done = new_done | (tok == int(eos_id))
        return top.reshape(-1), new_done, new_len, tok, rows

    # beam 0 live, beams 1..K-1 at -inf so the FIRST expansion takes the
    # top-K tokens of the prompt row, not K duplicates
    scores = torch.full((b, k_beams), _NEG, device=device)
    scores[:, 0] = 0.0
    scores = scores.reshape(-1)
    done = torch.zeros((bk,), dtype=torch.bool, device=device)
    gen_len = torch.zeros((bk,), dtype=torch.long, device=device)

    if cache is not None:
        y, cache = model.layer.apply_prefill(buf, cache)
        logits = y[:, p - 1] if lens is None else y[rows_all, lens - 1]
        for i in range(num_steps - 1):
            scores, done, gen_len, tok, rows = expand(scores, done,
                                                      gen_len, logits)
            pos = (p + i) if lens is None else (lens + i)
            buf = _write_at(buf[rows], tok, pos, t)
            cache = tree_map(lambda c: c[rows], cache)
            logits, cache = model.layer.apply_decode(tok, cache, pos)
        scores, done, gen_len, tok, rows = expand(scores, done, gen_len,
                                                  logits)
        buf = _write_at(buf[rows], tok, (p + num_steps - 1) if lens is None
                        else (lens + num_steps - 1), t)
    else:
        for i in range(num_steps):
            out = model(buf)
            logits = out[:, p - 1 + i] if lens is None \
                else out[rows_all, lens - 1 + i]
            scores, done, gen_len, tok, rows = expand(scores, done,
                                                      gen_len, logits)
            pos = (p + i) if lens is None else (lens + i)
            buf = _write_at(buf[rows], tok, pos, t)

    if length_penalty:
        scores = scores / gen_len.float().clamp(min=1.0) ** length_penalty
    scores = scores.reshape(b, k_beams)
    best = torch.argmax(scores, dim=-1)
    out = buf[torch.arange(b, device=device) * k_beams + best][:, :p + num_steps]
    return (out, scores.max(dim=-1).values) if return_scores else out
