"""LibriSpeech dataset: its split tables and the shared JSONL audio
pipeline of ``audioset`` (a copy of
``gtn_applications_tpu/datasets/librispeech.py``)."""

from . import audioset

SPLITS = {
    "train": ["train-clean-100"],
    "validation": ["dev-clean"],
    "test": ["test-clean", "test-other"],
}
SAMPLE_RATE = 16000


def load_data_split(data_path, split, wordsep=audioset.WORDSEP):
    return audioset.load_data_split(data_path, split, wordsep)


class Dataset(audioset.Dataset):
    splits = SPLITS
    sample_rate = SAMPLE_RATE


class Preprocessor(audioset.Preprocessor):
    def __init__(self, data_path, num_features, **kwargs):
        super().__init__(data_path, num_features, SPLITS, **kwargs)


if __name__ == "__main__":
    audioset.stats_cli(Dataset, Preprocessor)
