"""The port's speech datasets against the JAX package.

The port keeps jax-free copies of ``datasets/{audio,synthetic_audio,
audioset,librispeech,wsj,preprocess_librispeech,preprocess_wsj}.py`` and
binds the native FLAC decoder in its own ``wfst/native.py``.  Both are
host numpy, so every comparison is exact: the filterbank, mel features and
``log_normalize``; the masks under one seeded stream (a ``RandomState``
or numpy's global one); manifests, preprocessors, ``Dataset`` items and
``sample_sizes`` of audioset, librispeech and wsj on the WAV fixtures of
``tests/test_datasets.py`` and on FLAC ones (``tests/flac_fixture.py``),
with and without augmentation; ``decode_flac``; the manifest scripts on
their fixtures and goldens (``tests/test_preprocess_wsj.py``); the
synthetic tones.  Then ``load_experiment`` takes each speech dataset, and
one ``--disable_cuda`` epoch of the speech config of
``tests/test_train_e2e.py`` (tones, mel, TDS, CTC) runs through the port's
train.py and test.py.
"""

import json
import os
import wave

import numpy as np
import pytest

from gtn_applications_tpu.datasets import audio as jax_audio
from gtn_applications_tpu.datasets import audioset as jax_audioset
from gtn_applications_tpu.datasets import librispeech as jax_librispeech
from gtn_applications_tpu.datasets import preprocess_librispeech as jax_pls
from gtn_applications_tpu.datasets import preprocess_wsj as jax_pwsj
from gtn_applications_tpu.datasets import synthetic_audio as jax_synthetic_audio
from gtn_applications_tpu.datasets import wsj as jax_wsj
from gtn_applications_tpu.wfst import native as jax_native
from gtn_applications_tpu_torch import test as test_mod
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch.datasets import (
    audio, audioset, librispeech, preprocess_librispeech, preprocess_wsj,
    synthetic_audio, wsj,
)
from gtn_applications_tpu_torch.wfst import native

from tests import test_preprocess_wsj
from tests.flac_fixture import encode_flac

SR = 16000


def _write_wav(path, n, seed):
    rng = np.random.RandomState(seed)
    with wave.open(str(path), "w") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        x = np.sin(np.arange(n) * (0.03 + 0.01 * seed)) * 20000 + rng.randn(n) * 300
        w.writeframes(x.astype(np.int16).tobytes())


def _flac_bytes(n, seed, channels=1):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, channels) * 2000).astype(np.int64)
    return bytes(encode_flac(x if channels > 1 else x[:, 0], SR, subframe_mode="fixed"))


def test_mel_filterbank_and_normalize_equal():
    rng = np.random.RandomState(0)
    x = (rng.randn(SR) * 0.3).astype(np.float32)
    for args in ((SR, 400, 80), (SR, 512, 40), (8000, 200, 23)):
        assert np.array_equal(audio.mel_filterbank(*args), jax_audio.mel_filterbank(*args))
    f = np.linspace(0, 8000, 17)
    assert np.array_equal(audio.hz_to_mel(f), jax_audio.hz_to_mel(f))
    assert np.array_equal(audio.mel_to_hz(f), jax_audio.mel_to_hz(f))
    for kw in ({}, dict(n_mels=40, n_fft=512, hop_length=128)):
        m, mj = audio.MelSpectrogram(**kw)(x), jax_audio.MelSpectrogram(**kw)(x)
        assert m.dtype == mj.dtype and np.array_equal(m, mj)
        assert np.array_equal(audio.log_normalize(m), jax_audio.log_normalize(mj))


@pytest.mark.parametrize("seeded", ["rng", "global"])
def test_masks_equal_under_one_seed(seeded):
    x = np.random.RandomState(1).rand(40, 300).astype(np.float32)
    outs = []
    for mod in (audio, jax_audio):
        masks = [mod.FrequencyMasking(27), mod.TimeMasking(100), mod.FrequencyMasking(5),
                 mod.TimeMasking(0), mod.FrequencyMasking(400)]
        np.random.seed(3)
        rng = np.random.RandomState(3) if seeded == "rng" else None
        y = x
        for _ in range(4):
            for m in masks:
                y = m(y, rng)
        outs.append(y)
    assert np.array_equal(*outs) and (outs[0] == 0).any()


def test_decode_flac_equal():
    if not jax_native.available():
        pytest.skip("the JAX package's native library is not built")
    for n, channels, seed in ((1600, 1, 0), (3000, 2, 1), (17, 1, 2)):
        data = _flac_bytes(n, seed, channels)
        got, want = native.decode_flac(data), jax_native.decode_flac(data)
        assert got[1:] == want[1:] and np.array_equal(got[0], want[0])
        assert got[0].shape == (n, channels)
    with pytest.raises(ValueError):
        native.decode_flac(b"fLaC not a stream")


def _manifest_tree(root, names, flac=False):
    """Audio files and one manifest a split name, each naming them all."""
    entries = []
    for i, text in enumerate(["ab ba", "a\tbb  ab", "ba"]):
        if flac:
            path = root / f"u{i}.flac"
            path.write_bytes(_flac_bytes(SR // 2 + 800 * i, i))
        else:
            path = root / f"u{i}.wav"
            _write_wav(path, SR // 2 + 800 * i, i)
        entries.append({"text": text, "duration": 0.5 + 0.05 * i, "audio": str(path)})
    for name in names:
        with open(root / f"{name}.json", "w") as fid:
            for e in entries:
                fid.write(json.dumps(e) + "\n")


def _same_dataset(ds, ds_j):
    assert len(ds) == len(ds_j) and ds.sample_sizes() == ds_j.sample_sizes()
    assert ds.dataset == ds_j.dataset and len(ds.augmentation) == len(ds_j.augmentation)
    for i in range(len(ds)):
        np.random.seed(10 + i)
        feats, tgt = ds[i]
        np.random.seed(10 + i)
        feats_j, tgt_j = ds_j[i]
        assert feats.dtype == feats_j.dtype and np.array_equal(feats, feats_j)
        assert list(tgt) == list(tgt_j)


@pytest.mark.parametrize("kind", ["audioset", "librispeech", "wsj", "librispeech_flac"])
def test_speech_datasets_equal(tmp_path, kind):
    """Manifests, preprocessors, items and sample sizes, with and without
    augmentation (SpecAugment under numpy's global stream, seeded before
    each item)."""
    flac = kind.endswith("flac")
    if flac and not jax_native.available():
        pytest.skip("the JAX package's native library is not built")
    name = kind.split("_")[0]
    if name == "audioset":
        splits = {"train": ["tr"], "validation": ["va"]}
        _manifest_tree(tmp_path, ["tr", "va"])
        pre = audioset.Preprocessor(str(tmp_path), 40, splits)
        pre_j = jax_audioset.Preprocessor(str(tmp_path), 40, splits)
        make = lambda mod, p, split, aug: mod.Dataset(  # noqa: E731
            str(tmp_path), p, split, splits, augment=aug)
        mods = (audioset, jax_audioset)
        assert audioset.load_data_split(str(tmp_path), "tr") == \
            jax_audioset.load_data_split(str(tmp_path), "tr")
    else:
        port_mod, jax_mod = {"librispeech": (librispeech, jax_librispeech),
                             "wsj": (wsj, jax_wsj)}[name]
        _manifest_tree(tmp_path, sorted({s for v in port_mod.SPLITS.values() for s in v}),
                       flac)
        assert port_mod.SPLITS == jax_mod.SPLITS
        pre = port_mod.Preprocessor(str(tmp_path), num_features=40)
        pre_j = jax_mod.Preprocessor(str(tmp_path), num_features=40)
        make = lambda mod, p, split, aug: mod.Dataset(  # noqa: E731
            str(tmp_path), p, split=split, augment=aug)
        mods = (port_mod, jax_mod)
    assert pre.tokens == pre_j.tokens and pre.num_features == pre_j.num_features
    assert pre.use_words is False
    for split in ("train", "validation"):
        for aug in (False, True):
            _same_dataset(make(mods[0], pre, split, aug), make(mods[1], pre_j, split, aug))
    with pytest.raises(ValueError):
        audioset.Preprocessor(str(tmp_path), 40, {"train": []}, use_words=True)


def test_synthetic_audio_equal():
    pre = synthetic_audio.Preprocessor(None, 40)
    pre_j = jax_synthetic_audio.Preprocessor(None, 40)
    assert pre.tokens == pre_j.tokens
    for split in ("train", "validation", "test"):
        ds = synthetic_audio.Dataset(None, pre, split=split)
        ds_j = jax_synthetic_audio.Dataset(None, pre_j, split=split)
        assert ds.texts == ds_j.texts and ds.sample_sizes() == ds_j.sample_sizes()
        for i in range(len(ds)):
            assert np.array_equal(ds[i][0], ds_j[i][0]) and list(ds[i][1]) == list(ds_j[i][1])
    with pytest.raises(ValueError):
        synthetic_audio.Dataset(None, pre, split="dev")


def test_preprocess_librispeech_equal(tmp_path):
    """The manifest script on a LibriSpeech chapter tree of FLAC files:
    the same bytes as JAX's, and the durations of JAX's own test."""
    split = "dev-clean"
    chapter = tmp_path / split / "19" / "198"
    chapter.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for utt, frames in [("19-198-0000", 1600), ("19-198-0001", 8000)]:
        data = encode_flac((rng.randn(frames) * 1000).astype(np.int64), SR)
        (chapter / f"{utt}.flac").write_bytes(bytes(data))
    (chapter / "19-198.trans.txt").write_text("19-198-0000 HELLO WORLD\n19-198-0001 GOOD DAY\n")
    outs = []
    for mod in (preprocess_librispeech, jax_pls):
        out = tmp_path / mod.__name__.split(".")[0]
        out.mkdir()
        mod.write_manifest(tmp_path, out, split)
        outs.append((out / f"{split}.json").read_bytes())
    assert outs[0] == outs[1] and preprocess_librispeech.SPLITS == jax_pls.SPLITS
    rows = [json.loads(line) for line in outs[0].decode().splitlines()]
    assert [r["text"] for r in rows] == ["hello world", "good day"]
    assert abs(rows[1]["duration"] - 8000 / SR) < 1e-6
    assert preprocess_librispeech.flac_duration(chapter / "19-198-0001.flac") == \
        jax_pls.flac_duration(chapter / "19-198-0001.flac")


def test_preprocess_wsj_equal(tmp_path, monkeypatch):
    """JAX's own WSJ tests (the cleaning goldens and the LDC-shaped fixture
    pipeline) run against the port's module, and the fixture's manifest is
    JAX's byte for byte."""
    monkeypatch.setattr(test_preprocess_wsj, "pp", preprocess_wsj)
    test_preprocess_wsj.test_clean_goldens()
    test_preprocess_wsj.test_fixture_pipeline(tmp_path)
    for name in ("DATASETS", "DOT_PATHS", "REPLACE"):
        assert getattr(preprocess_wsj, name) == getattr(jax_pwsj, name)
    root = str(tmp_path / "wsj")
    waves = jax_pwsj.load_waves(root, jax_pwsj.DATASETS["eval_92"])
    assert preprocess_wsj.load_waves(root, preprocess_wsj.DATASETS["eval_92"]) == waves
    transcripts = jax_pwsj.load_text(root)
    assert preprocess_wsj.load_text(root) == transcripts
    outs = []
    for mod in (preprocess_wsj, jax_pwsj):
        out = tmp_path / mod.__name__.split(".")[0]
        out.mkdir()
        mod.write_json(str(out), "eval_92", waves, transcripts)
        outs.append((out / "eval_92.json").read_bytes())
    assert outs[0] == outs[1]


def test_load_audio_equal(tmp_path):
    _write_wav(tmp_path / "a.wav", 5000, 3)
    paths = [str(tmp_path / "a.wav")]
    if jax_native.available():
        (tmp_path / "b.flac").write_bytes(_flac_bytes(4000, 4, channels=2))
        paths.append(str(tmp_path / "b.flac"))
    for path in paths:
        (x, sr), (xj, srj) = audio.load_audio(path), jax_audio.load_audio(path)
        assert sr == srj and x.dtype == xj.dtype and np.array_equal(x, xj)


def _speech_config(tmp_path):
    return {
        "seed": 0,
        "data": {"dataset": "synthetic_audio", "data_path": str(tmp_path),
                 "num_features": 40},
        "model_type": "tds",
        "model": {"tds_groups": [{"channels": 2, "num_blocks": 1, "stride": 2}],
                  "kernel_size": 5, "dropout": 0.0},
        "criterion_type": "ctc",
        "optim": {"batch_size": 8, "epochs": 1, "learning_rate": 0.05, "step_size": 40,
                  "max_grad_norm": 5},
    }


@pytest.mark.parametrize("kind", ["synthetic_audio", "audioset", "librispeech", "wsj"])
def test_load_experiment_speech(tmp_path, kind):
    config = _speech_config(tmp_path)
    if kind != "synthetic_audio":
        mod = {"audioset": audioset, "librispeech": librispeech, "wsj": wsj}[kind]
        names = ["train"] if kind == "audioset" else \
            sorted({s for v in mod.SPLITS.values() for s in v})
        _manifest_tree(tmp_path, names)
        config["data"]["dataset"] = kind
    if kind == "audioset":
        # the generic dataset takes its split table as an argument, as JAX's
        with pytest.raises(TypeError):
            train_mod.load_experiment(config)
        return
    dataset, pre, crit, model, n = train_mod.load_experiment(config)
    assert dataset.__name__.endswith(kind) and n == 40 and crit.impl == "auto"
    assert pre.num_tokens + 1 == model.linear.out_features


def test_train_speech_epoch(tmp_path):
    """``tests/test_train_e2e.py::test_train_audio_pipeline``'s config:
    synthetic tones, mel, TDS, CTC, one epoch on the CPU, then test.py."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(_speech_config(tmp_path)))
    argv = ["--config", str(cfg), "--checkpoint_path", str(tmp_path), "--disable_cuda"]
    _, history = train_mod.train(train_mod.parse_args(argv))
    assert np.isfinite(history[0]["train_loss"]) and np.isfinite(history[0]["val_loss"])
    assert os.path.exists(tmp_path / "model.checkpoint")
    meters = test_mod.run_test(test_mod.parse_args(argv))
    assert meters.num_samples == 12 and np.isfinite(meters.avg_loss)
