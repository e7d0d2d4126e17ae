"""Wordpiece vocabulary + lexicon builder CLI.

A copy of ``gtn_applications_tpu/scripts/make_wordpieces.py`` over the
port's datasets: induce a wordpiece vocabulary from the *training split
only* of IAM / WSJ / LibriSpeech (or from ``--text_file``) with the unigram
trainer of ``scripts.wordpiece`` and write ``{prefix}_tokens_{N}.txt`` (the
N pieces, by decreasing log-probability) and ``{prefix}_lex_{N}.txt``
(word -> piece decomposition), byte for byte the files JAX's writes.

    python -m gtn_applications_tpu_torch.scripts.make_wordpieces \
        --dataset iamdb --data_dir DATA --num_pieces 1000 \
        --output_prefix word_pieces

Each dataset contributes a corpus builder returning (training sentences,
lexicon vocabulary or None, extra user symbols); everything downstream is
shared.
"""

import argparse
import os

from . import wordpiece


def _iam_corpus(data_dir):
    """IAM keeps transcripts in forms metadata; the training sentences are
    the forms whose keys appear in no eval split list."""
    from ..datasets import iamdb

    eval_keys = set()
    for split_files in iamdb.SPLITS.values():
        for name in split_files:
            with open(os.path.join(data_dir, name + ".txt")) as fid:
                eval_keys.update(line.strip() for line in fid)
    sentences = [
        line["text"]
        for lines in iamdb.load_metadata(data_dir, "▁").values()
        for line in lines
        if line["key"] not in eval_keys
    ]
    # IAM lexica include the "/" symbol
    return sentences, None, ["/"]


def _jsonl_corpus(module):
    """WSJ/LibriSpeech read training text from the JSONL manifests."""

    def build(data_dir):
        sentences = []
        for name in module.SPLITS["train"]:
            sentences.extend(
                entry["text"]
                for entry in module.load_data_split(data_dir, name)
            )
        return sentences, None, []

    return build


def _wsj_corpus(data_dir):
    from ..datasets import wsj

    sentences, _, syms = _jsonl_corpus(wsj)(data_dir)
    # WSJ uses the published 20k open vocabulary for the lexicon
    with open(os.path.join(data_dir, "vocab20ko.txt")) as fid:
        vocab = [
            line.strip().lower() for line in fid if not line.startswith("#")
        ]
    return sentences, vocab, syms


def _librispeech_corpus(data_dir):
    from ..datasets import librispeech

    return _jsonl_corpus(librispeech)(data_dir)


CORPUS_BUILDERS = {
    "iamdb": _iam_corpus,
    "wsj": _wsj_corpus,
    "librispeech": _librispeech_corpus,
}


def save_pieces(model, num_pieces, output_prefix, vocab):
    print(f"Generating word piece list of size {num_pieces}.")
    pieces = sorted(model.log_probs, key=model.log_probs.get, reverse=True)
    pieces = pieces[:num_pieces]
    print(f"Encoding vocabulary of size {len(vocab)}.")
    enc = model._native_encoder()
    if enc is not None:
        # encode() prepends the dummy "▁"; replicate for the batch call
        encoded_vocab = enc.encode_batch(["▁" + v for v in vocab])
    else:
        encoded_vocab = [model.encode(v) for v in vocab]

    with open(output_prefix + f"_tokens_{num_pieces}.txt", "w") as fid:
        fid.write("\n".join(pieces))
    with open(output_prefix + f"_lex_{num_pieces}.txt", "w") as fid:
        for v, p in zip(vocab, encoded_vocab):
            fid.write("{} {}\n".format(v, " ".join(p)))


def build_pieces(dataset, data_dir, num_pieces, output_prefix, text_file=None):
    sentences, vocab, user_symbols = CORPUS_BUILDERS[dataset](data_dir)
    if vocab is None:
        vocab = sorted(
            {w for text in sentences for w in text.split("▁") if w}
        )
    training_text = sentences
    if text_file is not None:
        with open(text_file) as fid:
            training_text = [line.strip() for line in fid]
    model = wordpiece.train_unigram(
        training_text, num_pieces, user_symbols=user_symbols
    )
    save_pieces(model, num_pieces, output_prefix, vocab)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Make the word piece list for a dataset."
    )
    parser.add_argument(
        "--dataset",
        default="iamdb",
        type=str,
        choices=sorted(CORPUS_BUILDERS),
    )
    parser.add_argument("--data_dir", default="<data_path>", type=str)
    parser.add_argument("--text_file", default=None, type=str)
    parser.add_argument("--output_prefix", default="word_pieces", type=str)
    parser.add_argument("--num_pieces", default=1000, type=int)
    args = parser.parse_args(argv)
    print(f"Building word pieces for {args.dataset}")
    build_pieces(
        args.dataset, args.data_dir, args.num_pieces,
        args.output_prefix, args.text_file,
    )


if __name__ == "__main__":
    main()
