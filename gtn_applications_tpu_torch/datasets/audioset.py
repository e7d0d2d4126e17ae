"""Generic JSONL-manifest audio dataset.

A copy of ``gtn_applications_tpu/datasets/audioset.py``: manifests are
``{split}.json`` files of JSON lines ``{"text": ..., "duration": ...,
"audio": ...}``; features are 25 ms / 10 ms-hop log-mel spectrograms
standardised per utterance; augmentation is a list of callables (the
SpecAugment masks of ``audio``).
"""

import json
import os
import re

from .audio import MelSpectrogram, load_audio, log_normalize
from .text import TextPreprocessor, WORDSEP


def load_data_split(data_path, split, wordsep=WORDSEP):
    json_file = os.path.join(data_path, f"{split}.json")
    with open(json_file, "r") as fid:
        examples = [json.loads(l) for l in fid]
        for ex in examples:
            text = re.sub(r"\s", wordsep, ex["text"]).strip(wordsep)
            ex["text"] = text
    return examples


def specaugment_stack():
    """The SpecAugment recipe both audio wrappers train with: two 27-bin
    frequency masks + two 100-frame time masks (the reference recipe's
    librispeech and wsj datasets)."""
    from .audio import FrequencyMasking, TimeMasking

    return [
        FrequencyMasking(27),
        FrequencyMasking(27),
        TimeMasking(100),
        TimeMasking(100),
    ]


class Dataset:
    # subclasses (wsj/librispeech) pin these and use the short ctor form
    splits = None
    sample_rate = 16000

    def __init__(
        self,
        data_path,
        preprocessor,
        split,
        splits=None,
        augmentation=None,
        sample_rate=None,
        augment=False,
    ):
        splits = splits if splits is not None else self.splits
        sample_rate = (
            sample_rate if sample_rate is not None else self.sample_rate
        )
        if augmentation is None and augment:
            augmentation = specaugment_stack()
        data = []
        for sp in splits[split]:
            data.extend(load_data_split(data_path, sp, preprocessor.wordsep))

        self.preprocessor = preprocessor
        self.mel = MelSpectrogram(
            sample_rate=sample_rate,
            n_fft=sample_rate * 25 // 1000,
            n_mels=preprocessor.num_features,
            hop_length=sample_rate * 10 // 1000,
        )
        self.augmentation = augmentation or []
        self.sample_rate = sample_rate

        audio = [ex["audio"] for ex in data]
        text = [ex["text"] for ex in data]
        duration = [ex["duration"] for ex in data]
        self.dataset = list(zip(audio, text, duration))

    def sample_sizes(self):
        """[( (duration, 1), target_len )] (audioset.py:52-57)."""
        return [((duration, 1), len(text)) for _, text, duration in self.dataset]

    def __getitem__(self, index):
        audio_file, text, _ = self.dataset[index]
        samples, sr = load_audio(audio_file)
        feats = log_normalize(self.mel(samples))
        for aug in self.augmentation:
            feats = aug(feats)
        outputs = self.preprocessor.to_index(text)
        return feats, outputs  # feats: [num_features, frames]

    def __len__(self):
        return len(self.dataset)


class Preprocessor(TextPreprocessor):
    """Audio dataset preprocessor (audioset.py:70-165)."""

    def __init__(
        self,
        data_path,
        num_features,
        splits,
        tokens_path=None,
        lexicon_path=None,
        use_words=False,
        prepend_wordsep=False,
    ):
        if use_words:
            raise ValueError("use_words not supported for audio dataset")
        data = []
        for sp in splits["train"]:
            data.extend(load_data_split(data_path, sp, WORDSEP))
        super().__init__(
            [ex["text"] for ex in data],
            tokens_path=tokens_path,
            lexicon_path=lexicon_path,
            prepend_wordsep=prepend_wordsep,
        )
        self.num_features = num_features

    @property
    def use_words(self):
        return False


def stats_cli(dataset_cls, preprocessor_cls):
    """Shared ``__main__`` for the audio wrappers: token/split counts plus
    optional text/token dumps (the reference repeats this block per
    dataset module)."""
    import argparse

    parser = argparse.ArgumentParser(description="Compute data stats.")
    parser.add_argument("--data_path", type=str, help="Path to dataset JSONs.")
    parser.add_argument("--save_text", type=str, default=None)
    parser.add_argument("--save_tokens", type=str, default=None)
    args = parser.parse_args()

    pre = preprocessor_cls(args.data_path, 80)
    print(f"Number of tokens: {pre.num_tokens}")
    trainset = dataset_cls(args.data_path, pre, split="train")
    if args.save_text is not None:
        with open(args.save_text, "w") as fid:
            fid.write("\n".join(t for _, t, _ in trainset.dataset))
    if args.save_tokens is not None:
        with open(args.save_tokens, "w") as fid:
            fid.write("\n".join(pre.tokens))
    print(f"Training: {len(trainset)}")
    for split in ("validation", "test"):
        n = len(dataset_cls(args.data_path, pre, split=split))
        print(f"{split.capitalize()}: {n}")
