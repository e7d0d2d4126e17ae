"""Prepare the WSJ dataset's manifests.

A copy of ``gtn_applications_tpu/datasets/preprocess_wsj.py``.  It walks
the LDC WSJ0/WSJ1 release: utterance transcripts come from the ``.dot``
files, per-split utterance lists from the ``.ndx`` index files.
Transcripts are normalised (lexical noise markers, punctuation-word
spellings, stray markup), sphere files are optionally converted to wav
with sph2pipe (``scripts/install_sph2pipe.sh``), and one ``{split}.json``
manifest of ``{"text", "duration", "audio"}`` lines is written a split.
Durations are read from the wav header with the standard library.  The
index paths, the dot-file globs and the punctuation-word table are the
LDC release's; the cleaning rules are JAX's exactly, so the manifests
are byte for byte JAX's.

    python -m gtn_applications_tpu_torch.datasets.preprocess_wsj \
        --data_path WSJ --save_path OUT [--convert]
"""

import argparse
import glob
import json
import os
import re
import subprocess
import wave as wavelib

# per-split .ndx index files within the LDC release
DATASETS = {
    "train_si284": [
        "csr_2_comp/13-34.1/wsj1/doc/indices/si_tr_s.ndx",
        "csr_1/11-13.1/wsj0/doc/indices/train/tr_s_wv1.ndx",
    ],
    "eval_92": ["csr_1/11-13.1/wsj0/doc/indices/test/nvp/si_et_20.ndx"],
    "dev_93": ["csr_2_comp/13-34.1/wsj1/doc/indices/h1_p0.ndx"],
}

DOT_PATHS = [
    "csr_1/*/wsj0/transcrp/dots/*/*/*.dot",
    "csr_2_comp/13-34.1/wsj1/trans/wsj1/*/*/*.dot",
    "csr_1/11-14.1/wsj0/si_et_20/*/*.dot",
]

# verbalized-punctuation spellings -> plain words
REPLACE = {
    ".point": "point",
    ".period": "period",
    "'single-quote": "single-quote",
    "'single-close-quote": "single-close-quote",
    "`single-quote": "single-quote",
    "-hyphen": "hyphen",
    ")close_paren": "close-paren",
    "(left(-paren)-": "left-",
    ".": "",
    "--dash": "dash",
    "-dash": "dash",
}

_MARKUP = re.compile(r"<|>|\\|\[\S+\]")
_DASH_COMPOUND = re.compile(r"\S+-dash")
_PAREN_GROUP = re.compile(r"\(\S*\)")
_PUNCT = re.compile(r"[()\*\":\?;!}{\~<>/&,\$\%\~]")


def _normalize_token(tok):
    """One raw token -> list of cleaned tokens (possibly empty)."""
    if _DASH_COMPOUND.match(tok):
        return tok.split("-")
    return [REPLACE.get(tok, tok)]


def clean(line):
    """Normalize one raw dot-file transcript line."""
    line = _MARKUP.sub("", line.lower())
    words = [w for tok in line.split() for w in _normalize_token(tok) if w]
    line = _PAREN_GROUP.sub("", " ".join(words).strip())
    line = _PUNCT.sub("", line)
    return " ".join(line.replace("`", "'").split())


def load_text(wsj_base):
    """utterance id -> cleaned transcript, over every dot file."""
    table = {}
    for pattern in DOT_PATHS:
        for path in glob.glob(os.path.join(wsj_base, pattern)):
            with open(path, "r") as fid:
                for raw in fid:
                    words = raw.strip().split()
                    if not words:
                        continue
                    # trailing token is the parenthesized utterance id
                    utt_id = words[-1][1:-1]
                    table[utt_id] = clean(" ".join(words[:-1]))
    return table


def _disk_dir(label):
    """ndx disk label '13_34_1' -> release directory name '13-34.1'."""
    a, b, c = label.split("_")
    return f"{a}-{b}.{c}"


def load_waves(wsj_base, index_files):
    """Resolve one split's .ndx indices to absolute audio paths."""
    waves = []
    for index in index_files:
        release_root = index.split(os.sep)[0]
        entries = []
        with open(os.path.join(wsj_base, index), "r") as fid:
            for raw in fid:
                if raw.startswith(";"):
                    continue
                disk, _, rel = raw.partition(":")
                entries.append(
                    os.path.join(
                        wsj_base, release_root, _disk_dir(disk),
                        rel.strip().strip("/"),
                    )
                )
        waves.extend(sorted(entries))
    return waves


def wav_duration(path):
    with wavelib.open(path, "rb") as w:
        return w.getnframes() / w.getframerate()


def write_json(save_path, dataset, waves, transcripts):
    with open(os.path.join(save_path, dataset + ".json"), "w") as fid:
        for wave_file in waves:
            utt_id = os.path.splitext(os.path.basename(wave_file))[0]
            fid.write(
                json.dumps(
                    {
                        "text": transcripts[utt_id],
                        "duration": wav_duration(wave_file),
                        "audio": wave_file,
                    }
                )
            )
            fid.write("\n")


def convert_sph_to_wav(files, out_path):
    sph2pipe = ["sph2pipe_v2.5/sph2pipe", "-p", "-f", "wav", "-c", "1"]
    converted = []
    for sph in files:
        stem, ext = os.path.splitext(os.path.basename(sph))
        if ext == "":
            sph += ".wv1"
        wav = os.path.join(out_path, stem + ".wav")
        subprocess.call(sph2pipe + [sph, wav])
        converted.append(wav)
    return converted


def main(argv=None):
    parser = argparse.ArgumentParser(description="Preprocess WSJ dataset.")
    parser.add_argument("--data_path", help="Location of WSJ root directory.")
    parser.add_argument("--save_path", default=".")
    parser.add_argument("--convert", action="store_true")
    args = parser.parse_args(argv)

    transcripts = load_text(args.data_path)
    for split, indices in DATASETS.items():
        waves = load_waves(args.data_path, indices)
        if split == "train_si284":
            # drop the corrupt speaker-401 shard of si_tr_s
            waves = [w for w in waves if "wsj0/si_tr_s/401" not in w]
        out_path = os.path.abspath(os.path.join(args.save_path, split))
        os.makedirs(out_path, exist_ok=True)
        if args.convert:
            print(f"Converting {split}")
            waves = convert_sph_to_wav(waves, out_path)
        print(f"Writing {split}")
        write_json(args.save_path, split, waves, transcripts)


if __name__ == "__main__":
    main()
