"""Beam search with KV-cached decoding (counterpart of
``singa_tpu/generate/beam.py``; reference model/BeamSearch.py).

Semantics follow the reference: top-2K candidate expansion, EOS candidates
ranked above K are dropped, finished hypotheses are length-penalty scored
(logp_sum / len^penalty), early exit when every batch element's worst kept
hypothesis beats the best possible live continuation. The loop is a Python
loop with the same exit test. Every top-k is a stable descending sort, so
ties go to the lower index, as ``jax.lax.top_k`` breaks them.
"""
from __future__ import annotations

from typing import Callable

import torch

from singa_tpu_torch.config import EOS_TOKEN, PAD_TOKEN, SOS_TOKEN
from singa_tpu_torch.generate import grammar as _grammar

NEG = -1e9
# Finite demotion of a beam whose only admissible token is the grammar
# safety valve's forced EOS (an invalid completion).
FORCED_EOS_PENALTY = 25.0


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _penalty(length: int, length_penalty: float) -> torch.Tensor:
    """length^penalty, computed in float32 as the JAX package computes it."""
    return torch.tensor(float(length), dtype=torch.float32) ** length_penalty


def _take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, M, ...] gathered along axis 1 by idx [B, J] -> [B, J, ...]."""
    shape = idx.shape + t.shape[2:]
    idx = idx.reshape(idx.shape + (1,) * (t.ndim - 2)).expand(shape)
    return torch.gather(t, 1, idx)


def beam_search(
    decode_fn: Callable,
    batch_size: int,
    num_beams: int,
    max_length: int,
    length_penalty: float = 0.7,
    sos_token: int = SOS_TOKEN,
    eos_token: int = EOS_TOKEN,
    pad_token: int = PAD_TOKEN,
    topk: int = 1,
    grammar_mask: bool = False,
    allow_dot: bool = True,
    device=None,
):
    """Run beam search.

    Args:
      decode_fn: ``(tokens [B*K, T], cur_len, keep_rows) -> logits [B*K, V]``
        — next-token logits after position ``cur_len - 1``. ``keep_rows``
        [B*K] (or None on the first step) says which row of the previous
        step each row continues, for a KV cache to follow.
      topk: hypotheses returned per batch element.
      grammar_mask: apply the SMILES grammar + valence mask to each step's
        log-probs; ``allow_dot`` admits '.' under it.

    Returns ``(tokens [B, topk, T], scores [B, topk])``.
    """
    B, K, T = batch_size, num_beams, max_length
    tokens = torch.full((B, K, T), pad_token, dtype=torch.int32, device=device)
    tokens[:, :, 0] = sos_token
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    fin_tokens = torch.full((B, K, T), pad_token, dtype=torch.int32, device=device)
    fin_scores = torch.full((B, K), NEG, dtype=torch.float32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    gram = _grammar.init_state((B, K), device) if grammar_mask else None
    rank = torch.arange(2 * K, device=device).expand(B, 2 * K)
    arange_k = torch.arange(K, device=device).expand(B, K)
    base = (torch.arange(B, device=device) * K)[:, None]
    keep_rows = None

    cur_len = 1
    while cur_len < T and not bool(done.all()):
        logits = decode_fn(tokens.reshape(B * K, T), cur_len, keep_rows)
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1)
        if grammar_mask:
            ok, forced = _grammar.allowed_tokens(gram, allow_dot=allow_dot, return_forced=True)
            logp = torch.where(ok.reshape(B * K, V), logp, NEG)
            logp = logp - forced.reshape(B * K, 1).to(logp.dtype) * FORCED_EOS_PENALTY
        cand = (scores.reshape(B * K, 1) + logp).reshape(B, K * V)
        top_scores, top_idx = top_k(cand, 2 * K)  # [B, 2K]
        beam_idx = top_idx // V
        tok_idx = top_idx % V
        is_eos = tok_idx == eos_token

        # finished candidates: EOS within the first K ranks
        fin_cand_valid = is_eos & (rank < K)
        pen = _penalty(cur_len, length_penalty)  # hypothesis length excl. EOS
        fin_cand_scores = torch.where(
            fin_cand_valid, top_scores / pen, torch.full_like(top_scores, NEG)
        )
        src_tokens = _take_rows(tokens, beam_idx)  # [B, 2K, T]
        all_scores = torch.cat([fin_scores, fin_cand_scores], dim=1)
        all_tokens = torch.cat([fin_tokens, src_tokens], dim=1)
        keep_scores, keep_idx = top_k(all_scores, K)
        new_fin_tokens = _take_rows(all_tokens, keep_idx)
        fin_scores = torch.where(done[:, None], fin_scores, keep_scores)
        fin_tokens = torch.where(done[:, None, None], fin_tokens, new_fin_tokens)

        # live beams: best K non-EOS candidates
        live_key = torch.where(is_eos, torch.full_like(top_scores, NEG), top_scores)
        live_scores, live_sel = top_k(live_key, K)
        live_beam = torch.gather(beam_idx, 1, live_sel)
        live_tok = torch.gather(tok_idx, 1, live_sel)
        new_tokens = _take_rows(tokens, live_beam)
        new_tokens[:, :, cur_len] = live_tok.to(torch.int32)
        tokens = torch.where(done[:, None, None], tokens, new_tokens)
        new_scores = torch.where(done[:, None], scores, live_scores)

        # rows of the next step continue these rows of this step
        keep_beam = torch.where(done[:, None], arange_k, live_beam)
        keep_rows = (keep_beam + base).reshape(-1)

        if grammar_mask:
            gram = _grammar.GrammarState(*(_take_rows(x, keep_beam) for x in gram))
            stepped = _grammar.update(gram, live_tok)

            def _sel(new, old):
                m = done.reshape((B, 1) + (1,) * (new.ndim - 2))
                return torch.where(m, old, new)

            gram = _grammar.GrammarState(*(_sel(n, o) for n, o in zip(stepped, gram)))

        # done condition (BeamHypotheses.is_done, BeamSearch.py:29-35)
        heap_full = fin_scores > NEG / 2
        worst_kept = torch.where(heap_full, fin_scores, torch.inf).amin(dim=1)
        best_live = new_scores.amax(dim=1) / pen
        done = done | (heap_full.all(dim=1) & (worst_kept >= best_live))
        scores = new_scores
        cur_len += 1

    # flush remaining live beams for unfinished batches (BeamSearch.py:141-149)
    live_pen = torch.where(done[:, None], NEG, scores / _penalty(cur_len, length_penalty))
    if grammar_mask:
        # a flushed beam with an open ring/branch/bond is known-invalid
        incomplete = (gram.rings != 0) | (gram.depth != 0) | (gram.pending != 0)
        live_pen = live_pen - incomplete.to(live_pen.dtype) * FORCED_EOS_PENALTY
    all_scores = torch.cat([fin_scores, live_pen], dim=1)
    all_tokens = torch.cat([fin_tokens, tokens], dim=1)
    final_scores, sel = top_k(all_scores, K)
    final_tokens = _take_rows(all_tokens, sel)
    return final_tokens[:, :topk], final_scores[:, :topk]


def beam_generate(
    model,
    enc: torch.Tensor,
    enc_pad_mask: torch.Tensor,
    prop: torch.Tensor | None,
    *,
    num_beams: int,
    max_length: int,
    length_penalty: float = 0.7,
    topk: int = 1,
    grammar_mask: bool = False,
    allow_dot: bool = True,
):
    """KV-cached beam search for a batch of encoded pockets.

    ``model`` is a SINGA (``prime_cache`` / ``decode_token``). The cache is
    primed with the property prefix for every (pocket, beam) row, written in
    place at each step, and reordered with ``index_select`` to follow the
    selected beams. Returns ``(tokens [B, topk, T], scores [B, topk])``.
    """
    B = enc.shape[0]
    enc_rep = enc.repeat_interleave(num_beams, dim=0)
    pad_rep = enc_pad_mask.repeat_interleave(num_beams, dim=0)
    prop_rep = None if prop is None else prop.repeat_interleave(num_beams, dim=0)
    cache = model.prime_cache(enc_rep, pad_rep, prop_rep)

    def decode_fn(tokens, cur_len, keep_rows):
        if keep_rows is not None:
            cache.reorder(keep_rows)
        last = tokens[:, cur_len - 1 : cur_len]
        return model.decode_token(last, cur_len - 1, cache)

    return beam_search(
        decode_fn,
        batch_size=B,
        num_beams=num_beams,
        max_length=max_length,
        length_penalty=length_penalty,
        topk=topk,
        grammar_mask=grammar_mask,
        allow_dot=allow_dot,
        device=enc.device,
    )
