"""Build LibriSpeech JSONL manifests (torchaudio-free).

A copy of ``gtn_applications_tpu/datasets/preprocess_librispeech.py``.
LibriSpeech lays out ``<root>/<split>/<speaker>/<chapter>/`` directories,
each holding ``<speaker>-<chapter>.trans.txt`` plus one FLAC per
utterance id named in that file.  The manifest is one JSON object per
line: ``{"text": ..., "duration": seconds, "audio": flac path}``, the
schema ``datasets/audioset.py`` reads.  Durations come from soundfile
when available, else from the FLAC STREAMINFO header, parsed with the
standard library.

    python -m gtn_applications_tpu_torch.datasets.preprocess_librispeech \
        --data_path LIBRISPEECH --save_path OUT
"""

import argparse
import json
import struct
from pathlib import Path

SPLITS = [
    "train-clean-100", "dev-clean", "dev-other", "test-clean", "test-other",
]


def flac_duration(path):
    """Duration in seconds from the FLAC STREAMINFO block (no decoder)."""
    try:
        import soundfile as sf

        info = sf.info(path)
        return info.frames / info.samplerate
    except ImportError:
        pass
    with open(path, "rb") as fid:
        if fid.read(4) != b"fLaC":
            raise ValueError(f"{path} is not a FLAC file")
        fid.read(4)  # metadata block header
        # first metadata block must be STREAMINFO (34 bytes)
        block = fid.read(34)
        sample_rate = (block[10] << 12) | (block[11] << 4) | (block[12] >> 4)
        total = ((block[13] & 0x0F) << 32) | struct.unpack(">I", block[14:18])[0]
        return total / sample_rate


def iter_utterances(split_dir):
    """Yield (flac_path, raw_transcript) by walking each chapter's
    ``*.trans.txt``; the FLAC for an utterance id sits beside it."""
    for trans in sorted(Path(split_dir).glob("*/*/*.trans.txt")):
        chapter_dir = trans.parent
        for line in trans.read_text().splitlines():
            utt_id, _, words = line.strip().partition(" ")
            if utt_id:
                yield chapter_dir / (utt_id + ".flac"), words


def write_manifest(data_path, save_path, split):
    out_file = Path(save_path) / (split + ".json")
    with open(out_file, "w") as fid:
        for flac, words in iter_utterances(Path(data_path) / split):
            entry = {
                "text": words.strip().lower(),
                "duration": flac_duration(flac),
                "audio": str(flac),
            }
            fid.write(json.dumps(entry) + "\n")


def main():
    parser = argparse.ArgumentParser(description="Preprocess librispeech dataset.")
    parser.add_argument("--data_path", type=str)
    parser.add_argument("--save_path", type=str)
    args = parser.parse_args()
    for split in SPLITS:
        print(f"Preprocessing {split}")
        write_manifest(args.data_path, args.save_path, split)


if __name__ == "__main__":
    main()
