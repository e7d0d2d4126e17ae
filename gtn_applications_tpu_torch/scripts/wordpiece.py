"""Unigram-LM wordpiece vocabulary induction and segmentation.

A copy of ``gtn_applications_tpu/scripts/wordpiece.py``, kept in the port
so that building a wordpiece inventory imports nothing of the JAX package;
both train the same model and write the same files.  The algorithm is the
SentencePiece unigram family, without an external tokenizer:

  * seed vocabulary: frequent substrings (plus all single characters),
  * EM over all segmentations (forward-backward in log space),
  * iterative pruning by expected count down to the target size,
  * Viterbi segmentation for encoding, with the SentencePiece
    ``add_dummy_prefix`` convention (a leading "▁" on every sequence).

Encoding and the E-step take the native segmenter (``wfst.native``) where
``native.enabled()``, exactly where JAX's take theirs: the native and the
Python E-steps accumulate in a different order, so the same switch keeps
the inventories equal.  Piece ids follow the reference's output files: id
0 is <unk>, pieces are ids 1..N, saved as ``{prefix}_tokens_{N}.txt`` /
``{prefix}_lex_{N}.txt`` (``scripts/make_wordpieces.py``).
"""

import collections
import math
from typing import Dict

WORDSEP = "▁"
_NEG = -1e30


class UnigramModel:
    """Trained piece -> log prob table with Viterbi encoding.

    Encoding dispatches to the native segmenter (wfst.native) where it is
    enabled; the Python DP below is the oracle."""

    def __init__(self, log_probs: Dict[str, float]):
        self.log_probs = dict(log_probs)
        self.max_len = max((len(p) for p in log_probs), default=1)
        self._native = None

    def _native_encoder(self):
        if self._native is None:
            from ..wfst import native

            if native.enabled():
                pieces = list(self.log_probs)
                self._native = native.WordpieceEncoder(
                    pieces, [self.log_probs[p] for p in pieces]
                )
            else:
                self._native = False
        return self._native or None

    def encode(self, text, add_dummy_prefix=True):
        """Viterbi segmentation into pieces; unknown characters fall back
        to themselves with a strong penalty (character coverage 1.0 makes
        this rare on training-domain text)."""
        if add_dummy_prefix:
            text = WORDSEP + text
        enc = self._native_encoder()
        if enc is not None:
            return enc.encode(text)
        n = len(text)
        best = [_NEG] * (n + 1)
        back = [None] * (n + 1)
        best[0] = 0.0
        for e in range(1, n + 1):
            for s in range(max(0, e - self.max_len), e):
                piece = text[s:e]
                lp = self.log_probs.get(piece)
                if lp is None:
                    if e - s == 1:
                        lp = -100.0  # unk char fallback
                    else:
                        continue
                cand = best[s] + lp
                if cand > best[e]:
                    best[e] = cand
                    back[e] = s
        pieces = []
        e = n
        while e > 0:
            s = back[e]
            pieces.append(text[s:e])
            e = s
        pieces.reverse()
        return pieces

    def encode_ids(self, text, piece_to_id, add_dummy_prefix=True, unk_id=0):
        return [
            piece_to_id.get(p, unk_id)
            for p in self.encode(text, add_dummy_prefix)
        ]


def _seed_vocab(sentences, max_piece_len=16, seed_size=100000):
    """Frequent substrings scored by count * length, plus all chars."""
    substr_counts = collections.Counter()
    char_counts = collections.Counter()
    for sent in sentences:
        n = len(sent)
        for i in range(n):
            char_counts[sent[i]] += 1
            for j in range(i + 2, min(n, i + max_piece_len) + 1):
                substr_counts[sent[i:j]] += 1
    # drop singletons, keep the top seed_size by count*len
    scored = [
        (cnt * len(s), s) for s, cnt in substr_counts.items() if cnt >= 2
    ]
    scored.sort(reverse=True)
    pieces = {s for _, s in scored[:seed_size]}
    pieces.update(char_counts.keys())
    total = sum(substr_counts.values()) + sum(char_counts.values())
    log_probs = {}
    for p in pieces:
        cnt = substr_counts[p] if len(p) > 1 else char_counts[p]
        log_probs[p] = math.log(max(cnt, 1)) - math.log(total)
    return log_probs, set(char_counts.keys())


def _e_step(sentences, model: UnigramModel):
    """Forward-backward expected piece counts over all segmentations.

    Dispatches to the native implementation where it is enabled (the
    Python DP below is the oracle); vocabulary induction over real corpora
    is minutes-vs-seconds work."""
    enc = model._native_encoder()
    if enc is not None:
        from ..wfst import native

        return native.wordpiece_estep(enc, sentences)
    expected = collections.defaultdict(float)
    total_ll = 0.0
    max_len = model.max_len
    lp = model.log_probs
    for sent in sentences:
        n = len(sent)
        # forward
        alpha = [_NEG] * (n + 1)
        alpha[0] = 0.0
        matches = [[] for _ in range(n + 1)]  # at end e: list of (s, piece, logp)
        for e in range(1, n + 1):
            best = _NEG
            acc = 0.0
            m = matches[e]
            for s in range(max(0, e - max_len), e):
                piece = sent[s:e]
                plp = lp.get(piece)
                if plp is None:
                    if e - s == 1:
                        plp = -100.0
                    else:
                        continue
                m.append((s, piece, plp))
                v = alpha[s] + plp
                if v > best:
                    best = v
            if best <= _NEG / 2:
                alpha[e] = _NEG
                continue
            for s, piece, plp in m:
                acc += math.exp(alpha[s] + plp - best)
            alpha[e] = best + math.log(acc)
        if alpha[n] <= _NEG / 2:
            continue
        total_ll += alpha[n]
        # backward
        beta = [_NEG] * (n + 1)
        beta[n] = 0.0
        for s in range(n - 1, -1, -1):
            best = _NEG
            vals = []
            for e in range(s + 1, min(n, s + max_len) + 1):
                piece = sent[s:e]
                plp = lp.get(piece)
                if plp is None:
                    if e - s == 1:
                        plp = -100.0
                    else:
                        continue
                v = plp + beta[e]
                vals.append(v)
                if v > best:
                    best = v
            if best <= _NEG / 2:
                continue
            beta[s] = best + math.log(
                sum(math.exp(v - best) for v in vals)
            )
        # posteriors
        for e in range(1, n + 1):
            for s, piece, plp in matches[e]:
                post = alpha[s] + plp + beta[e] - alpha[n]
                if post > -30:
                    expected[piece] += math.exp(post)
    return expected, total_ll


def fit_scores(sentences, pieces, em_iters=4, add_dummy_prefix=True):
    """Fit unigram log-probs for a FIXED piece inventory by EM.

    Closes the gap between a published piece list (one that ships pieces
    but not the SentencePiece model's scores) and score-faithful Viterbi
    encoding:
    every piece is kept — EM only re-estimates its probability — so the
    returned UnigramModel's id space matches the published file exactly.
    Pieces never seen in the corpus get a floor probability."""
    sentences = [
        (WORDSEP + s if add_dummy_prefix else s) for s in sentences if s
    ]
    n_pieces = len(set(pieces))
    uniform = -math.log(max(n_pieces, 1))
    model = UnigramModel({p: uniform for p in pieces})
    for _ in range(em_iters):
        expected, _ll = _e_step(sentences, model)
        total = sum(expected.values())
        if total <= 0:
            break
        model = UnigramModel(
            {
                p: math.log(max(expected.get(p, 0.0), 1e-8)) - math.log(total)
                for p in model.log_probs
            }
        )
    return model


def train_unigram(
    sentences,
    vocab_size,
    max_piece_len=16,
    seed_size=100000,
    em_iters=2,
    shrink_factor=0.75,
    user_symbols=(),
    add_dummy_prefix=True,
    verbose=False,
):
    """Train a unigram wordpiece model of ``vocab_size`` pieces.

    Mirrors the SentencePiece training loop: EM refits piece probabilities,
    then the vocabulary shrinks by ``shrink_factor`` per round (never
    dropping single characters or user symbols) until the target size.
    """
    sentences = [
        (WORDSEP + s if add_dummy_prefix else s) for s in sentences if s
    ]
    log_probs, chars = _seed_vocab(sentences, max_piece_len, seed_size)
    required = set(chars) | set(user_symbols)
    for sym in user_symbols:
        log_probs.setdefault(sym, math.log(1e-6))

    model = UnigramModel(log_probs)
    while True:
        for _ in range(em_iters):
            expected, ll = _e_step(sentences, model)
            total = sum(expected.values())
            if total <= 0:
                break
            new_lp = {}
            for p in model.log_probs:
                cnt = expected.get(p, 0.0)
                if cnt > 1e-8 or p in required:
                    new_lp[p] = math.log(max(cnt, 1e-8)) - math.log(total)
            model = UnigramModel(new_lp)
            if verbose:
                print(f"EM: ll={ll:.1f}, vocab={len(new_lp)}")
        current = len(model.log_probs)
        if current <= vocab_size:
            break
        # prune lowest-expected pieces (keep required)
        expected, _ = _e_step(sentences, model)
        prunable = [
            (expected.get(p, 0.0), p)
            for p in model.log_probs
            if p not in required
        ]
        prunable.sort(reverse=True)
        keep_n = max(
            int(current * shrink_factor) - len(required), vocab_size - len(required)
        )
        kept = {p for _, p in prunable[:keep_n]} | required
        total = sum(expected.get(p, 1e-8) for p in kept)
        model = UnigramModel(
            {
                p: math.log(max(expected.get(p, 1e-8), 1e-8)) - math.log(total)
                for p in kept
            }
        )
        if verbose:
            print(f"pruned to {len(model.log_probs)}")

    # final truncation to exactly vocab_size by probability
    if len(model.log_probs) > vocab_size:
        ranked = sorted(
            model.log_probs.items(),
            key=lambda kv: (kv[0] in required, kv[1]),
            reverse=True,
        )
        model = UnigramModel(dict(ranked[:vocab_size]))
    return model
