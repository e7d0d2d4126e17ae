"""Shared text preprocessing: grapheme/token/lexicon maps.

A copy of ``gtn_applications_tpu/datasets/text.py``, kept in the port so
that it imports nothing of the JAX package: the token logic of the
upstream per-dataset Preprocessors in one array-native core — grapheme
inventory from training text, optional token list and word->wordpiece
lexicon with letter fallback, the "▁" word separator, and the inverse maps
used for CER/WER scoring.
"""

import numpy as np

WORDSEP = "▁"


class TextPreprocessor:
    """Token/lexicon maps shared by all dataset preprocessors.

    Args:
      train_text: iterable of training transcripts (wordsep-delimited).
      tokens_path: optional path to the model output token list.
      lexicon_path: optional word -> token-sequence lexicon; enables
        word-level tokenization with letter fallback
        (``lexicon.get(w, wordsep + w)``, iamdb.py:199).
      prepend_wordsep: prepend the word separator to every target
        (wordpiece decomposition training, audioset.py:147-151).
    """

    def __init__(
        self,
        train_text,
        tokens_path=None,
        lexicon_path=None,
        prepend_wordsep=False,
    ):
        self.wordsep = WORDSEP
        self._prepend_wordsep = prepend_wordsep

        graphemes = set()
        for text in train_text:
            graphemes.update(text)
        self.graphemes = sorted(graphemes)

        if tokens_path is None:
            self.tokens = self.graphemes
        else:
            with open(tokens_path, "r") as fid:
                self.tokens = [line.strip() for line in fid]

        self.lexicon = None
        if lexicon_path is not None:
            self.lexicon = {}
            with open(lexicon_path, "r") as fid:
                for raw in fid:
                    fields = raw.strip().split()
                    if fields:
                        self.lexicon[fields[0]] = fields[1:]

        self.graphemes_to_index = dict(
            zip(self.graphemes, range(len(self.graphemes)))
        )
        self.tokens_to_index = dict(zip(self.tokens, range(len(self.tokens))))

    @property
    def num_tokens(self):
        return len(self.tokens)

    def _word_pieces(self, word):
        """Wordpiece decomposition of one word.

        Out-of-lexicon words are spelled out letter by letter with the word
        separator glued to the first letter (the reference's letter fallback,
        iamdb.py:199) — returning the string lets the caller iterate its
        characters exactly like a piece list.
        """
        pieces = self.lexicon.get(word)
        return self.wordsep + word if pieces is None else pieces

    def to_index(self, line):
        if self.lexicon is None:
            vocab = self.graphemes_to_index
            stream = list(line)
        else:
            vocab = self.tokens_to_index
            stream = []
            for word in line.split(self.wordsep) if line else []:
                stream.extend(self._word_pieces(word))
        if self._prepend_wordsep:
            stream.insert(0, self.wordsep)
        return np.asarray([vocab[t] for t in stream], dtype=np.int32)

    def to_text(self, indices):
        vocab = self.tokens if self.lexicon is not None else self.graphemes
        return self._render(vocab, indices)

    def tokens_to_text(self, indices):
        return self._render(self.tokens, indices)

    def _render(self, vocab, indices):
        # Leading/trailing word separators carry no text.
        return "".join(vocab[int(i)] for i in indices).strip(self.wordsep)
