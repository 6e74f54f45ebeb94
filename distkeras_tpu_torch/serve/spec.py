"""Speculative decoding — decode accelerator #2 (the port of
``distkeras_tpu.serve.spec``; distribution-preserving, so ``spec_k``
composes with ``temperature > 0``).

One-token-per-step decode leaves the target model memory-bound: every
step reads the full parameter set to produce ONE token per row.  A small
**draft** model proposes ``k`` tokens per active row; the target then
verifies all ``k`` in ONE batched ``decode_window`` — the accepted prefix
ships ``m + 1`` tokens (the ``m`` accepted proposals plus one final
token) for a single target-weight read plus one fix-up decode.

Acceptance is per-row, under the row's OWN sampling params:

* **Greedy rows** (``temperature == 0``): a proposal ``x_i`` is accepted
  iff it equals the target's own argmax given the previously accepted
  context, so every emitted token is exactly the token
  ``generate_tokens`` would have produced — at ANY draft quality.  A bad
  draft costs speed (low accept rate), never correctness.
* **Sampled rows** (``temperature > 0``): the draft proposes
  ``x_i ~ q_i`` (its own tempered, filtered distribution,
  ``rowwise_dist``), the target accepts with probability
  ``min(1, p_i(x_i) / q_i(x_i))`` where ``p_i`` is ITS tempered,
  filtered distribution given the accepted context; on the first
  rejection the final token is drawn from the normalized residual
  ``max(p_i - q_i, 0)``, and after ``k`` acceptances a bonus token is
  drawn from the target's next-position distribution.  The emitted
  sequence is distributed exactly as sampling from the target alone.
  The draws come from the engine's ``torch.Generator``, not
  ``jax.random``: the two packages agree in distribution, not draw by
  draw.

**Accepted-prefix rollback keeps the ragged KV cache exact** without
copying anything back: the verify window writes K/V for all ``k``
proposals, but a row's attention horizon is its own position, so K/V at
positions past ``pos + m`` is never attended before the row's later
decode *overwrites* it.  Rolling back IS just not advancing ``pos``.

PyTorch runs eagerly: the JAX package's ``lax.scan`` over proposals and
its ``lax.cond`` on "any row samples" are a Python loop and a host-side
flag here (the engine reads it from its host copy of the per-row
temperatures, so the branch costs no device sync).  The whole step is
one program behind one retrace sentinel (``serve.spec_step``).

Metrics (service registry, recorded by the engine): counters
``serve.spec.proposed`` / ``serve.spec.accepted``, gauge
``serve.spec.accept_rate``.
"""

from __future__ import annotations

import torch

from ..models.generation import (_categorical, _model_cache, _write_at,
                                 decode_window, rowwise_dist)

#: floor added before ``log`` on probability tensors — keeps zero-mass
#: entries at -inf-ish log-probability without producing NaN
_TINY = 1e-30


def validate_draft(model, draft_model, batch: int, spec_k: int) -> None:
    """Config-time rejection for a draft that cannot verify against this
    target: checked when the engine is built, never discovered by the
    decode thread."""
    if draft_model is None:
        raise ValueError(
            f"spec_k={spec_k} needs a draft model: pass draft_model= to "
            f"DecodeEngine (the gpt_lm family scales down to draft size)")
    vocab = int(model.output_shape[-1])
    dvocab = int(draft_model.output_shape[-1])
    if dvocab != vocab:
        raise ValueError(
            f"draft checkpoint is not shape-compatible with the target: "
            f"draft vocab {dvocab} != target vocab {vocab} (proposals "
            f"are verified token-by-token in one shared id space)")
    t = int(model.input_shape[0])
    dt = int(draft_model.input_shape[0])
    if dt != t:
        raise ValueError(
            f"draft seq_len {dt} != target seq_len {t}: the draft's KV "
            f"cache tracks the same absolute positions as the target's")
    if draft_model.device != model.device:
        raise ValueError(f"the draft lives on {draft_model.device}, the "
                         f"target on {model.device}")
    if _model_cache(draft_model, batch) is None:
        raise ValueError(
            "the draft model does not support the KV-cached decode path "
            "(init_cache protocol) — speculative proposal is a cached "
            "decode scan")


def build_spec_step(model, draft_model, spec_k: int):
    """The speculative step for ``DecodeEngine``.

    Returns ``fn(buf, cache, dcache, pos, logits, dlogits, active, temp,
    topk, topp, gen, sampled) -> (cache, dcache, pos, logits, dlogits,
    emitted, counts)``; ``buf`` is written in place.  ``emitted`` is
    (B, k+1) int64 — row r's tokens for positions
    ``pos_r .. pos_r + counts_r - 1`` — and ``counts`` is (B,) in
    [1, k+1] (valid only where ``active``).  ``temp``/``topk``/``topp``
    are the per-row sampling params ((B,) tensors; ``temp == 0`` selects
    the greedy argmax-acceptance path for that row); ``sampled`` (host
    bool) says whether any row samples, ``gen`` is the draws' generator.

    Alignment invariant (matches the engine's carried state): ``logits``
    / ``dlogits`` are each model's distribution for the token AT ``pos``.
    """
    k = int(spec_k)
    t = int(model.input_shape[0])

    def _spec_step(buf, cache, dcache, pos, logits, dlogits, active, temp,
                   topk, topp, gen, sampled):
        b = buf.shape[0]
        dev = buf.device
        rows = torch.arange(b, device=dev)
        greedy = temp <= 0.0                                # (B,)

        # 1) draft proposes k tokens: greedy rows take its carried
        # argmax, sampled rows draw x_i ~ q_i (q RECORDED: the
        # acceptance test and the residual both need it), each fed back
        # at position pos + i (clamped like every possibly-overrunning
        # write)
        xs, qs = [], []
        dl = dlogits
        for i in range(k):
            x = torch.argmax(dl, dim=-1)
            if sampled:
                q = rowwise_dist(dl, temp, topk, topp)      # (B, V)
                x = torch.where(greedy, x,
                                _categorical(gen, torch.log(q + _TINY)))
                qs.append(q)
            dl, dcache = draft_model.layer.apply_decode(
                x, dcache, (pos + i).clamp(max=t - 1))
            xs.append(x)
        proposals = torch.stack(xs, dim=1)                  # (B, k)

        # 2) target verifies all k proposals in one batched window
        win, cache = decode_window(model.layer, proposals, cache, pos,
                                   limit=t)                 # (B, k, V)

        # 3a) greedy acceptance: the target's own argmax chain
        y0 = torch.argmax(logits, dim=-1)[:, None]
        targets = torch.cat([y0, torch.argmax(win, dim=-1)], dim=1)
        acc = proposals == targets[:, :k]

        # 3b) stochastic acceptance: u <= p(x)/q(x), the
        # distribution-preserving test.  ``ps`` is the target's
        # tempered/filtered distribution for the token AT pos+i given
        # proposals[:, :i] — valid exactly when those proposals were all
        # accepted, which the cumulative product below encodes
        if sampled:
            qs = torch.stack(qs, dim=1)                     # (B, k, V)
            tgt = torch.cat([logits[:, None, :], win[:, :k - 1, :]],
                            dim=1)                          # (B, k, V)
            ps = rowwise_dist(tgt.reshape(b * k, -1),
                              temp.repeat_interleave(k),
                              topk.repeat_interleave(k),
                              topp.repeat_interleave(k)).reshape(b, k, -1)
            p_x = torch.gather(ps, -1, proposals[..., None])[..., 0]
            q_x = torch.gather(qs, -1, proposals[..., None])[..., 0]
            u = torch.rand((b, k), generator=gen, device=dev,
                           dtype=p_x.dtype)
            acc = torch.where(greedy[:, None], acc, u * q_x <= p_x)
        m = torch.cumprod(acc.long(), dim=1).sum(dim=1)     # (B,) in [0, k]
        counts = m + 1

        # 4) the final (m-th) emitted token per row: greedy -> the target
        # chain's own token; sampled + rejection at m < k -> a draw from
        # the normalized residual max(p_m - q_m, 0) (the epsilon
        # fallback to p_m covers numerically tied p == q); sampled + all
        # k accepted -> a bonus draw from the target's next-position
        # distribution
        final = torch.gather(targets, 1, m[:, None])[:, 0]
        if sampled:
            bonus = rowwise_dist(win[:, k - 1, :], temp, topk, topp)
            m_idx = m.clamp(max=k - 1)
            resid = (ps - qs).clamp(min=0.0)[rows, m_idx]   # (B, V)
            mass = resid.sum(dim=-1, keepdim=True)
            resid = torch.where(mass > 1e-9,
                                resid / mass.clamp(min=_TINY),
                                ps[rows, m_idx])
            final_dist = torch.where((m == k)[:, None], bonus, resid)
            final = torch.where(
                greedy, final,
                _categorical(gen, torch.log(final_dist + _TINY)))

        # row r emits proposals[:m_r] then `final` at index m_r
        idx = torch.arange(k + 1, device=dev)[None, :]
        prop_pad = torch.cat([proposals, proposals[:, -1:]], dim=1)
        emitted = torch.where(idx == m[:, None], final[:, None], prop_pad)

        # 5) emit into the buffer at pos .. pos+m (a write past seq_len is
        # dropped: the row is retiring)
        keep = (idx <= m[:, None]) & active[:, None]        # (B, k+1)
        for j in range(k + 1):
            _write_at(buf, emitted[:, j], pos + j, t, keep=keep[:, j])

        # 6) fix-up decode of the LAST emitted token (the correction /
        # bonus the draft never saw): gives the carried logits for
        # pos+m+1 and overwrites the one wrong K/V slot a rejected
        # proposal left at pos+m — both models stay exactly in sync with
        # the emitted context
        pfix = (pos + m).clamp(max=t - 1)
        l2, cache = model.layer.apply_decode(final, cache, pfix)
        logits = torch.where(active[:, None], l2.to(logits.dtype), logits)
        dl2, dcache = draft_model.layer.apply_decode(final, dcache, pfix)
        dlogits = torch.where(active[:, None], dl2.to(dlogits.dtype),
                              dlogits)
        pos = pos + counts * active.to(pos.dtype)
        return cache, dcache, pos, logits, dlogits, emitted, counts

    return _spec_step
