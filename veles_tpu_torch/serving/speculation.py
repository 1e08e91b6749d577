"""Speculative decoding: drafters, the acceptance rule, adaptive K.

A copy of the JAX package's ``veles_tpu/serving/speculation.py``, which
is host-side numpy: the port keeps its own so that it imports nothing
of that package.

Decode is one memory-bound ``paged_step`` dispatch per generated
token — the latency floor of the serving story.  Speculation raises
tokens/dispatch: a cheap DRAFTER proposes up to K continuation
tokens, and ONE ``paged_verify`` dispatch scores all K (plus the
bonus position) against the target model, accepting the longest
correct prefix.  Two drafters:

* **Prompt-lookup / n-gram** (:class:`NGramDrafter`) — match the last
  n tokens of prompt+generated against the row's OWN history and
  propose the continuation of the previous occurrence.  Zero model
  cost, host-side numpy, devastatingly effective on repetitive /
  extractive text (summaries, code, copy tasks) and harmless
  elsewhere (no match ⇒ no drafts ⇒ plain decode).
* **Draft model** — any second exported LM with the same vocabulary
  (``check_draft_compat``), running greedy one-token steps through
  its own small paged pool; K sequential cheap dispatches buy one
  expensive verify.

**Acceptance rule** (why quality is untouched): the verify program
samples the TARGET's token at every drafted position with the exact
PRNG fold index the non-speculative step loop would use
(``gen_idx + j`` per row — ``generate_bucketed``'s streams).  A
draft is accepted while it equals the target's own sample; the first
target sample that disagrees is emitted as the bonus token.  Greedy
(temperature 0) this is longest-prefix-match on argmax — decode is
BIT-IDENTICAL to the plain paged loop.  Sampled, both drafters
propose deterministically (point-mass proposals q), and for a
point-mass q the Leviathan speculative-sampling rule — accept x
with probability ``min(1, p(x)/q(x)) = p(x)``, on rejection draw
from the corrected residual ``norm(max(0, p − q)) = p | ≠x`` — is
realized EXACTLY by prefix-matching the target's own stream: the
target draws x with probability p(x) (acceptance), and conditioned
on drawing ≠x its sample IS the residual distribution.  Either way
the emitted sequence is distributed precisely as non-speculative
decode — which stays the oracle, bit for bit, seed for seed.

**Adaptive K** (:class:`SpecState`): an EWMA of per-round acceptance
drives each row's draft budget between 0 and ``spec_max_k`` —
adversarial (incompressible) rows decay to plain decode instead of
paying verify width for rejected drafts, with a periodic one-token
probe so a row that turns repetitive later can recover.
"""

import numpy

from ..error import Bug

#: Verify chunk widths must fit the flash-decode contract
#: (``ops.decode_attention.DECODE_MAX_Q`` = 16 query positions), so
#: K + 1 bonus position ≤ 16.
MAX_SPEC_K = 15

#: Shared empty proposal — "no match" costs no allocation.
NO_DRAFTS = numpy.zeros(0, numpy.int32)


class NGramDrafter(object):
    """Prompt-lookup drafting: propose the continuation of the most
    recent earlier occurrence of the context's final n-gram, longest
    n first.  Pure host-side numpy — no device work, no transfers."""

    def __init__(self, max_n=3, min_n=1):
        self.max_n = int(max_n)
        self.min_n = int(min_n)
        if not 1 <= self.min_n <= self.max_n:
            raise Bug("ngram sizes must satisfy 1 <= min_n <= max_n,"
                      " got %d..%d" % (self.min_n, self.max_n))

    def propose(self, ctx, n_ctx, k):
        """Up to ``k`` proposed tokens continuing ``ctx[:n_ctx]``
        (the row's prompt + generated history), or an empty array
        when no earlier occurrence of the trailing n-gram exists.

        The match at distance ``p`` from the end is continued
        CYCLICALLY (``hay[i+n+(t mod p)]``): repetitive text usually
        cycles with period ``p``, and a raw history slice would cap
        the proposal at the few tokens between the match and the
        present — wasting most of the verify width exactly where
        drafts land best.  Wrong guesses cost nothing but rejected
        verify columns."""
        k = int(k)
        n_ctx = int(n_ctx)
        if k < 1 or n_ctx < self.min_n + 1:
            return NO_DRAFTS
        hay = ctx[:n_ctx]
        for n in range(min(self.max_n, n_ctx - 1), self.min_n - 1,
                       -1):
            gram = hay[n_ctx - n:n_ctx]
            # Candidate start positions of a full-gram match that end
            # strictly before the trailing gram itself.
            limit = n_ctx - n  # starts 0..limit-1 are earlier
            if limit < 1:
                continue
            cand = numpy.flatnonzero(hay[n - 1:limit + n - 1] ==
                                     gram[-1])
            for i in cand[::-1]:
                if numpy.array_equal(hay[i:i + n], gram):
                    period = limit - i
                    idx = i + n + (numpy.arange(k) % period)
                    return numpy.ascontiguousarray(
                        hay[numpy.minimum(idx, n_ctx - 1)],
                        dtype=numpy.int32)
        return NO_DRAFTS


class SpecState(object):
    """Per-row speculation state: the adaptive draft budget and its
    acceptance EWMA, plus the row's pending drafts and host-side
    context buffer (prompt + generated, appended as tokens land —
    O(1) per token, so drafting never re-concatenates history)."""

    __slots__ = ("k", "ewma", "plain_streak", "drafts", "ctx",
                 "n_ctx")

    #: EWMA smoothing for per-round acceptance (accepted/drafted).
    ALPHA = 0.3
    #: Plain-decode steps at K == 0 before a one-token probe draft
    #: (a row that turns repetitive later must be able to recover).
    PROBE_AFTER = 32

    def __init__(self, max_k, capacity):
        self.k = int(max_k)
        self.ewma = 1.0  # optimistic start: first round drafts fully
        self.plain_streak = 0
        self.drafts = None
        self.ctx = numpy.zeros(int(capacity), numpy.int32)
        self.n_ctx = 0

    def extend_ctx(self, tokens):
        tokens = numpy.asarray(tokens, numpy.int32).ravel()
        end = self.n_ctx + tokens.size
        self.ctx[self.n_ctx:end] = tokens
        self.n_ctx = end

    def budget(self, max_k, adaptive):
        """The draft budget for this round (0 ⇒ plain decode),
        including the periodic probe that lets a decayed row
        recover."""
        if not adaptive:
            return int(max_k)
        if self.k == 0:
            self.plain_streak += 1
            if self.plain_streak >= self.PROBE_AFTER:
                self.plain_streak = 0
                return 1
        return self.k

    def update(self, accepted, drafted, max_k, adaptive):
        """Folds one verify round's outcome into the EWMA and
        re-derives K.  Rows that never match (no drafts proposed)
        are not punished — proposing nothing costs nothing."""
        if drafted < 1:
            return
        rate = float(accepted) / float(drafted)
        self.ewma = (1.0 - self.ALPHA) * self.ewma + \
            self.ALPHA * rate
        if adaptive:
            self.k = max(0, min(int(max_k),
                                int(round(self.ewma * max_k))))
            if self.k > 0:
                self.plain_streak = 0


def accept_lengths(drafts, draft_lens, targets):
    """The speculative acceptance rule, host-side: ``drafts``
    (B, K) proposed tokens, ``draft_lens`` (B,) true counts,
    ``targets`` (B, K+1) the target's sampled token per position
    (``paged_verify`` output).  Returns (B,) accepted counts a_i —
    the longest prefix where ``targets[i, j] == drafts[i, j]`` for
    j < draft_lens[i]; the row then emits
    ``drafts[i, :a_i] + [targets[i, a_i]]`` (a_i + 1 tokens)."""
    drafts = numpy.asarray(drafts)
    targets = numpy.asarray(targets)
    draft_lens = numpy.asarray(draft_lens)
    B, K = drafts.shape
    cols = numpy.arange(K)[None, :]
    match = (targets[:, :K] == drafts) & (cols < draft_lens[:, None])
    # First False per row = accepted length (argmin on ~match; an
    # all-True row accepts draft_lens).
    bad = ~match
    first_bad = numpy.where(bad.any(axis=1), bad.argmax(axis=1), K)
    return numpy.minimum(first_bad, draft_lens).astype(numpy.int64)


def check_draft_compat(target, draft):
    """Geometry gate for a draft model (the ``swap_weights``
    discipline applied across models): both must be causal LM
    artifacts over the SAME vocabulary, and the draft's positional
    table must cover every position the target can reach — a draft
    proposing from a different token space would never match, and a
    shorter table would fault mid-stream rather than at load time.
    Raises :class:`~veles_tpu_torch.error.Bug` with the mismatch."""
    t_pos = getattr(target, "max_position", None)
    d_pos = getattr(draft, "max_position", None)
    if not t_pos:
        raise Bug("speculative decoding requires a causal LM target "
                  "artifact")
    if not d_pos:
        raise Bug("draft artifact is not a causal LM "
                  "(no embedding -> blocks -> lm_head chain)")
    for name, model in (("target", target), ("draft", draft)):
        if not hasattr(model, "paged_step"):
            raise Bug("%s model has no paged decode surface" % name)
    t_units = getattr(target, "units", None)
    d_units = getattr(draft, "units", None)
    if not t_units or not d_units:
        raise Bug("draft compatibility needs exported artifacts "
                  "(unit tables) on both models")
    t_emb = t_units[0]
    d_emb = d_units[0]
    t_vocab = int(t_emb["config"]["vocab_size"])
    d_vocab = int(d_emb["config"]["vocab_size"])
    if t_vocab != d_vocab:
        raise Bug("draft/target vocabulary mismatch: draft %d vs "
                  "target %d — speculative tokens must share one "
                  "token space" % (d_vocab, t_vocab))
    if d_pos < t_pos:
        raise Bug("draft positional table (%d) is shorter than the "
                  "target's (%d) — the draft would fault on long "
                  "sequences instead of at load" % (d_pos, t_pos))
