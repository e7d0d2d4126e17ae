"""IAM handwriting dataset.

A copy of ``gtn_applications_tpu/datasets/iamdb.py``, kept in the port so
that it imports nothing of the JAX package: lines.txt / words.txt metadata
parsing with garbage-token cleanup and box extraction, threaded image
crop/resize loading, augmentation (random resize crop, small rotation,
brightness/contrast jitter), Normalize(0.912, 0.168), the ``sample_sizes``
protocol for width-sorted batching, and ``fast_pipeline``'s batch-wide
collate.  Images are numpy ``[H, W]`` float32 arrays; loading them needs
PIL on the host.
"""

import collections
import os
import random
import re

import numpy as np

from .text import TextPreprocessor, WORDSEP

try:
    import PIL.Image
    import PIL.ImageOps

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False

SPLITS = {
    "train": ["trainset"],
    "validation": ["validationset1"],
    "test": ["validationset2", "testset"],
}

NORM_MEAN = 0.912
NORM_STD = 0.168


def load_metadata(data_path, wordsep=WORDSEP, use_words=False):
    """Parse lines.txt / words.txt."""
    forms = collections.defaultdict(list)
    filename = "words.txt" if use_words else "lines.txt"
    with open(os.path.join(data_path, filename), "r") as fid:
        lines = (l.strip().split() for l in fid if l[0] != "#")
        for line in lines:
            if use_words and line[1] == "err":
                continue
            text = " ".join(line[8:])
            text = text.replace("#", "")
            text = re.sub(r"\|+|\s", wordsep, text).strip(wordsep)
            form_key = "-".join(line[0].split("-")[:2])
            line_key = "-".join(line[0].split("-")[:3])
            box_idx = 4 - use_words
            box = tuple(int(val) for val in line[box_idx : box_idx + 4])
            forms[form_key].append({"key": line_key, "box": box, "text": text})
    return forms


def load_image(example):
    """Crop the line/word box and resize to the target height."""
    img_file, box, height = example
    img = PIL.Image.open(img_file)
    x, y, w, h = box
    size_w = int((height / h) * w)
    img = img.crop((x, y, x + w, y + h)).resize(
        (size_w, height), PIL.Image.BILINEAR
    )
    return img


class RandomResizeCrop:
    """Pad-with-white, random crop offset, random aspect ratio."""

    def __init__(self, jitter=10, ratio=0.5):
        self.jitter = jitter
        self.ratio = ratio

    def __call__(self, img):
        w, h = img.size
        img = PIL.ImageOps.expand(img, border=self.jitter, fill=255)
        x = self.jitter + random.randint(-self.jitter, self.jitter)
        y = self.jitter + random.randint(-self.jitter, self.jitter)
        size_w = int(w * random.uniform(1 - self.ratio, 1 + self.ratio))
        img = img.crop((x, y, x + w, y + h)).resize(
            (size_w, h), PIL.Image.BILINEAR
        )
        return img


class Dataset:
    """IAM dataset with eager threaded image loading.

    ``fast_pipeline=True`` switches the per-sample/collate split for
    throughput: ``__getitem__`` stops at the PIL stage (uint8 pixels +
    the drawn jitter scalars — all GIL-releasing C work) and the
    float conversion / brightness / contrast / clip / Normalize run
    ONCE per batch as vectorized numpy passes inside ``collate_fn``
    (measured: the per-sample small-array numpy ops hold the GIL and
    cap DataLoader thread scaling).  Numerically equivalent to the
    default path (same op order, batch-level summation)."""

    def __init__(self, data_path, preprocessor, split, augment=False,
                 fast_pipeline=False):
        self.fast_pipeline = fast_pipeline
        forms = load_metadata(
            data_path, preprocessor.wordsep, use_words=preprocessor.use_words
        )
        splits = SPLITS.get(split, None)
        if splits is None:
            split_names = ", ".join(f"'{k}'" for k in SPLITS.keys())
            raise ValueError(f"Invalid split {split}, must be in [{split_names}].")
        split_keys = []
        for s in splits:
            with open(os.path.join(data_path, f"{s}.txt"), "r") as fid:
                split_keys.extend(l.strip() for l in fid)
        split_keys = set(split_keys)

        self.preprocessor = preprocessor
        self.augment = augment

        images, text = [], []
        for key, examples in forms.items():
            for example in examples:
                if example["key"] not in split_keys:
                    continue
                img_file = os.path.join(data_path, f"{key}.png")
                images.append((img_file, example["box"], preprocessor.num_features))
                text.append(example["text"])
        # thread pool, not processes: PIL releases the GIL during
        # decode/resize, and forking a process that holds CUDA is unsafe
        from multiprocessing.pool import ThreadPool

        with ThreadPool(processes=16) as pool:
            images = pool.map(load_image, images)
        self.dataset = list(zip(images, text))

    def sample_sizes(self):
        """[( (width, height), target_len )] for width-sorted batching."""
        return [(img.size, len(text)) for img, text in self.dataset]

    def __getitem__(self, index):
        img, text = self.dataset[index]
        if self.augment:
            img = RandomResizeCrop()(img)
            angle = random.uniform(-2, 2)
            img = img.rotate(angle, PIL.Image.BILINEAR, fillcolor=255)
            bright = random.uniform(0.5, 1.5)
            contrast = random.uniform(0.5, 1.5)
        else:
            bright = contrast = 1.0
        outputs = self.preprocessor.to_index(text)
        if self.fast_pipeline:
            return np.asarray(img, dtype=np.uint8), (bright, contrast), outputs
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if self.augment:
            # brightness/contrast jitter (grayscale analogue of ColorJitter)
            arr = arr * bright
            mean = arr.mean()
            arr = (arr - mean) * contrast + mean
            arr = np.clip(arr, 0.0, 1.0)
        arr = (arr - NORM_MEAN) / NORM_STD
        return arr, outputs  # [H, W]

    @property
    def collate_fn(self):
        return self._collate_fast if self.fast_pipeline else None

    def _collate_fast(self, samples, width_multiple=16):
        """Vectorized finalize + pad for fast_pipeline samples.

        Same semantics as __getitem__'s float stage + utils.padding_collate
        (u8/255 * bright, mean-centered contrast over the unpadded region,
        clip to [0, 1], Normalize, zero padding), but each stage is one
        batch-wide numpy pass — GIL-released SIMD instead of B small-array
        ops.  The identity jitter (bright = contrast = 1) makes the
        non-augment path exact: u8/255 is already in [0, 1] so the clip is
        a no-op and centering cancels."""
        arrs, params, targets = zip(*samples)
        h = arrs[0].shape[0]
        widths = np.asarray([a.shape[1] for a in arrs], np.int32)
        max_w = -(-max(int(widths.max()), 1) // width_multiple) * width_multiple
        B = len(arrs)
        x = np.zeros((B, h, max_w), np.float32)
        for e, a in enumerate(arrs):
            x[e, :, : a.shape[1]] = a
        bright = np.asarray([p[0] for p in params], np.float32)
        contrast = np.asarray([p[1] for p in params], np.float32)
        x *= (bright / 255.0)[:, None, None]
        # padded zeros contribute 0 to the sums, so means are unpadded
        means = x.sum(axis=(1, 2)) / (h * widths.astype(np.float32))
        x *= contrast[:, None, None]
        x += (means * (1.0 - contrast))[:, None, None]
        np.clip(x, 0.0, 1.0, out=x)
        x -= NORM_MEAN
        x /= NORM_STD
        for e, w in enumerate(widths):
            x[e, :, w:] = 0.0
        return x, widths, list(targets)

    def __len__(self):
        return len(self.dataset)


class Preprocessor(TextPreprocessor):
    """IAM preprocessor: the text inventory of every form in the metadata."""

    def __init__(self, data_path, num_features, tokens_path=None,
                 lexicon_path=None, use_words=False,
                 prepend_wordsep=False):
        self._use_words = use_words
        forms = load_metadata(data_path, WORDSEP, use_words=use_words)
        train_text = [line["text"] for _, form in forms.items() for line in form]
        super().__init__(
            train_text,
            tokens_path=tokens_path,
            lexicon_path=lexicon_path,
            prepend_wordsep=prepend_wordsep,
        )
        self.num_features = num_features

    @property
    def use_words(self):
        return self._use_words


def _cli(argv=None):
    """Dataset inspection / asset-export CLI.

    Flag names are a contract with scripts/iamdb_transitions.sh; the
    report formatting is the JAX package's.

        python -m gtn_applications_tpu_torch.datasets.iamdb --data_path DIR \
            [--use_words] [--save_text F] [--save_tokens F] [--compute_stats]
    """
    import argparse

    ap = argparse.ArgumentParser(
        description="IAM dataset report and train-text/token export."
    )
    ap.add_argument("--data_path", type=str, help="Path to dataset.")
    ap.add_argument("--use_words", default=False, action="store_true")
    ap.add_argument("--save_text", type=str, default=None)
    ap.add_argument("--save_tokens", type=str, default=None)
    ap.add_argument("--compute_stats", action="store_true", default=False)
    args = ap.parse_args(argv)

    pre = Preprocessor(args.data_path, 64, use_words=args.use_words)
    splits = {
        "train": Dataset(args.data_path, pre, split="train", augment=False)
    }

    exports = {
        args.save_text: lambda: (
            line for _, line in splits["train"].dataset
        ),
        args.save_tokens: lambda: iter(pre.tokens),
    }
    for path, rows in exports.items():
        if path is not None:
            with open(path, "w") as out:
                out.write("\n".join(rows()))

    for name in ("validation", "test"):
        splits[name] = Dataset(args.data_path, pre, split=name)
    counts = ", ".join(f"{k}={len(v)}" for k, v in splits.items())
    print(f"split sizes: {counts}")

    if args.compute_stats:
        train = splits["train"]
        pixels = np.concatenate(
            [train[i][0] for i in range(len(train))], axis=1
        )
        widths, tgt_lens = zip(
            *(((w, l)) for (w, _), l in train.sample_sizes())
        )
        print(
            f"pixel stats: mean={pixels.mean():.6f} std={pixels.std():.6f}"
        )
        print(
            f"averages: image_width={sum(widths) / len(train):.3f} "
            f"target_len={sum(tgt_lens) / len(train):.3f}"
        )


if __name__ == "__main__":
    _cli()
