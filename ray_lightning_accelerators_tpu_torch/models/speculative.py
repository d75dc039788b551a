"""Speculative decoding: a small draft model proposes, the target verifies.

Port of the JAX package's ``models/speculative.py``.  Greedy speculative
decoding is exact: the tokens equal target-only greedy ``generate()``,
but the target runs once per accepted run of draft tokens, scoring k
positions in one ``GPT._decode_chunk`` pass.

- No cache rollback: both caches are linear (slot == position) and every
  mask stops at the current position, so entries written for rejected
  draft tokens are never attended and are rewritten when real tokens land.
- Each round feeds the newest token (possibly a correction neither model
  has processed) at its position, so both caches stay consistent.
- Greedy only, batch 1, linear caches only (no sliding window).

``serve_speculative`` routes one request through the serve engine's
speculative lane (``serve/engine.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .transformer import GPT


def build_draft_proposer(draft: GPT, draft_params: Any, k: int
                         ) -> Callable[..., Tuple[Dict[str, torch.Tensor],
                                                  torch.Tensor]]:
    """Draft proposer ``(cache, tok [1], pos) -> (cache, [k] tokens)``:
    the draft cache absorbs ``tok`` at ``pos`` first, then extends
    greedily for ``k`` steps."""
    params = draft.unstack_layers(draft_params)

    def propose(cache, tok, pos):
        toks = []
        t = tok
        for i in range(k):
            logits, cache = draft._decode_token(params, cache, t, pos + i)
            t = torch.argmax(logits, dim=-1)
            toks.append(t)
        return cache, torch.cat(toks)

    return propose


def serve_speculative(engine: Any, prompt: Any, max_new_tokens: int,
                      timeout: Optional[float] = None) -> np.ndarray:
    """Route one single-stream request through a running
    ``ServeEngine``'s speculative lane (the engine must carry a draft
    model) and block for the full token sequence, token-identical to
    target-only greedy ``generate()`` whichever lane served it."""
    return engine.submit(prompt, max_new_tokens,
                         speculative=True).result(timeout)


@torch.no_grad()
def speculative_generate(target: GPT, target_params: Any, draft: GPT,
                         draft_params: Any, prompt: Any, max_new_tokens: int,
                         k: int = 4) -> Tuple[torch.Tensor, dict]:
    """Greedy decode of ``max_new_tokens`` tokens, exact against
    target-only greedy.  Returns (tokens [1, prompt + new] int32, stats
    with ``rounds`` and ``accept_rate``, the JAX package's two, plus
    ``accepted`` and ``checked``: the draft tokens accepted, and those the
    remaining budget let the target check -- equal for a draft that
    always agrees).  ``draft`` and ``target`` share the vocabulary; ``k``
    tokens are drafted per round."""
    prompt = torch.as_tensor(prompt, device=target.device).long()
    # single stream: acceptance length varies per row, so rows cannot
    # share a chunk pass
    if prompt.ndim != 2 or prompt.shape[0] != 1:
        raise ValueError(
            "speculative decoding is single-stream: expected a prompt "
            f"shaped [1, prompt_len], got {tuple(prompt.shape)} -- batch "
            "requests belong in serve.ServeEngine's continuous-batching "
            "slots; only batch-1 streams may route through speculative "
            "decode")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if target.cfg.sliding_window is not None or \
            draft.cfg.sliding_window is not None:
        raise NotImplementedError(
            "speculative decoding needs linear caches (sliding_window "
            "unsupported)")
    s0 = prompt.shape[1]
    total = s0 + max_new_tokens
    for m, name in ((target, "target"), (draft, "draft")):
        if total > m.cfg.max_seq_len:
            raise ValueError(f"{name} max_seq_len {m.cfg.max_seq_len} < "
                             f"{total}")
    target_params = target.unstack_layers(target_params)
    # k slots of headroom: the final round may draft and score up to k
    # positions past the last needed token (the port raises on an
    # out-of-range cache write where JAX's dynamic_update_slice clamps)
    cache_len = total + k
    h_t, t_cache = target._prefill(target_params, prompt, cache_len)
    _, d_cache = draft._prefill(draft_params, prompt.to(draft.device),
                                cache_len)
    propose = build_draft_proposer(draft, draft_params, k)
    dt = target.compute_dtype
    first = torch.argmax(
        (h_t @ target._unembed_w(target_params, dt)).float(), dim=-1)
    out = [int(first[0])]                    # the token at position s0
    rounds = accepted_total = checked = 0
    while len(out) < max_new_tokens:
        rounds += 1
        pos = s0 + len(out) - 1              # position of the newest token
        last = torch.tensor([out[-1]], device=draft.device)
        d_cache, draft_toks = propose(d_cache, last, pos)
        drafts = [int(t) for t in draft_toks.tolist()]
        # the target scores [last, d_1 .. d_{k-1}] in one chunk pass:
        # logits[i] predicts position pos + i + 1 (validates drafts[i])
        chunk = torch.tensor([[out[-1]] + drafts[:-1]], device=target.device)
        t_logits, t_cache = target._decode_chunk(target_params, t_cache,
                                                 chunk, pos)
        greedy = torch.argmax(t_logits[0], dim=-1).tolist()
        accept = 0
        while accept < k and greedy[accept] == drafts[accept] and \
                len(out) + accept + 1 < max_new_tokens:
            accept += 1
        accepted_total += accept
        checked += min(k, max_new_tokens - len(out) - 1)
        new = drafts[:accept] + [int(greedy[accept])] \
            if accept < k else drafts[:accept]
        out.extend(new[:max_new_tokens - len(out)])
    tokens = torch.cat([prompt, torch.tensor([out], device=prompt.device)],
                       dim=1).to(torch.int32)
    stats = {"rounds": rounds,
             "accept_rate": accepted_total / max(rounds * k, 1),
             "accepted": accepted_total, "checked": checked}
    return tokens, stats
