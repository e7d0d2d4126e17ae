"""Long-line synthetic glyph dataset.

A copy of ``gtn_applications_tpu/datasets/synthetic_long.py``: the glyph
corpus of ``datasets.synthetic`` with 3-4 words a line, each glyph 512
pixels wide, so a line is 4,096-9,728 columns.  At the time stride of 16
of ``configs/iamdb/pruned_ngram_ctc.json`` that is 256-608 frames, about
the frame count of a real IAM line, and well above the grapheme count,
which the Transducer without repeats needs.
"""

from . import synthetic
from .synthetic import Preprocessor  # noqa: F401  (same token inventory)

_LONG_GLYPH_W = 512


class Dataset(synthetic.Dataset):
    def __init__(self, data_path, preprocessor, split="train", augment=False):
        super().__init__(
            data_path, preprocessor, split, augment,
            glyph_w=_LONG_GLYPH_W, min_words=3, max_words=4,
        )
