"""Fit unigram scores for a published piece inventory.

A copy of ``gtn_applications_tpu/scripts/fit_piece_scores.py``.  A
published piece *list* (``word_pieces_tokens_1000.txt``) lacks the
SentencePiece model's scores, so segmentations cannot be reproduced from
the file alone.  This tool EM-fits scores for the fixed inventory over a
corpus (``wordpiece.fit_scores``) and writes them as ``piece<TAB>logprob``
TSV (``benchmarks/word_pieces_scores_1000.tsv`` is such a file); encoding
with those scores is then deterministic and portable.

With --corpus absent, a deterministic Zipf pseudo-corpus is synthesized
from the inventory's own word-like pieces (piece files are ordered roughly
by decreasing score, so file rank is a usable frequency proxy).

Usage:
  python -m gtn_applications_tpu_torch.scripts.fit_piece_scores \
      --pieces word_pieces_tokens_1000.txt --output scores.tsv
"""

import argparse

import numpy as np

from .wordpiece import WORDSEP, fit_scores


def zipf_corpus(pieces, num_sentences=2000, words_per_sentence=8, seed=0):
    """Deterministic pseudo-corpus: Zipf-sample word-initial pieces by
    their rank in the piece file."""
    words = [p[len(WORDSEP):] for p in pieces if p.startswith(WORDSEP) and len(p) > len(WORDSEP)]
    ranks = np.arange(1, len(words) + 1, dtype=np.float64)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    rng = np.random.RandomState(seed)
    sentences = []
    for _ in range(num_sentences):
        idx = rng.choice(len(words), size=words_per_sentence, p=probs)
        sentences.append(WORDSEP.join(words[i] for i in idx))
    return sentences


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pieces", required=True,
                        help="piece list, one per line (ids are 1-based; "
                        "id 0 is <unk>)")
    parser.add_argument("--corpus", default=None,
                        help="text corpus, one sentence per line (default: "
                        "synthesized Zipf pseudo-corpus)")
    parser.add_argument("--output", required=True, help="piece\\tscore TSV")
    parser.add_argument("--em_iters", type=int, default=4)
    args = parser.parse_args(argv)

    with open(args.pieces) as fh:
        pieces = [l.rstrip("\n") for l in fh if l.rstrip("\n")]
    if args.corpus:
        with open(args.corpus) as fh:
            sentences = [
                l.strip().replace(" ", WORDSEP) for l in fh if l.strip()
            ]
    else:
        sentences = zipf_corpus(pieces)

    model = fit_scores(sentences, pieces, em_iters=args.em_iters)
    with open(args.output, "w") as fh:
        for p in pieces:  # preserve file order == id order
            fh.write(f"{p}\t{model.log_probs[p]:.8f}\n")
    print(f"wrote {len(pieces)} scores to {args.output}")


def load_scores(path):
    """Read a piece<TAB>score TSV -> (pieces list in id order, log_probs)."""
    pieces, log_probs = [], {}
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            piece, score = line.split("\t")
            pieces.append(piece)
            log_probs[piece] = float(score)
    return pieces, log_probs


if __name__ == "__main__":
    main()
