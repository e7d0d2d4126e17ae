"""Audio features: mel spectrograms and SpecAugment masks in numpy.

A copy of ``gtn_applications_tpu/datasets/audio.py``, kept in the port so
that it imports nothing of the JAX package: a torch-free mel spectrogram
with torchaudio's defaults (power 2, HTK mel scale, no filterbank norm,
reflect-padded centred frames, hann window), per-utterance log
standardisation, and the frequency and time masks, which draw from the
caller's numpy random stream (``np.random`` by default), so seeded masks
are JAX's.  WAV loads through the standard library; FLAC through the
native decoder (``wfst.native.decode_flac``), else ``soundfile``.
"""

import wave

import numpy as np


def load_audio(path):
    """Load PCM audio.  WAV via stdlib; FLAC/other via soundfile when
    available (LibriSpeech ships FLAC)."""
    if path.endswith(".wav"):
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            width = w.getsampwidth()
            channels = w.getnchannels()
            data = w.readframes(n)
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        x = np.frombuffer(data, dtype=dtype).astype(np.float32)
        if width == 1:
            x = (x - 128.0) / 128.0
        else:
            x = x / float(2 ** (8 * width - 1))
        if channels > 1:
            x = x.reshape(-1, channels).mean(axis=1)
        return x, sr
    if path.endswith(".flac"):
        from ..wfst import native

        if native.available():
            with open(path, "rb") as fid:
                samples, sr, bits = native.decode_flac(fid.read())
            x = samples.astype(np.float32) / float(2 ** (bits - 1))
            if x.shape[1] > 1:
                x = x.mean(axis=1)
            else:
                x = x[:, 0]
            return x, sr
    try:
        import soundfile as sf

        x, sr = sf.read(path, dtype="float32")
        if x.ndim > 1:
            x = x.mean(axis=1)
        return x, sr
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            f"Cannot load {path}: non-WAV audio requires the native FLAC "
            "decoder (make -C native) or the 'soundfile' package (or convert "
            "with preprocess_librispeech.py first)"
        ) from e


def hz_to_mel(f):
    """HTK mel scale (torchaudio default)."""
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(sample_rate, n_fft, n_mels, f_min=0.0, f_max=None):
    """Triangular mel filterbank [n_freqs, n_mels] (torchaudio melscale_fbanks
    semantics: HTK scale, no norm)."""
    f_max = f_max or sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


class MelSpectrogram:
    """torchaudio-compatible mel spectrogram (power 2, centered, hann)."""

    def __init__(self, sample_rate=16000, n_fft=400, n_mels=80, hop_length=160):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
        self.fb = mel_filterbank(sample_rate, n_fft, n_mels)

    def __call__(self, x):
        """x: [T] float32 -> [n_mels, frames]."""
        pad = self.n_fft // 2
        x = np.pad(x, pad, mode="reflect")
        n_frames = 1 + (len(x) - self.n_fft) // self.hop_length
        idx = (
            np.arange(n_frames)[:, None] * self.hop_length
            + np.arange(self.n_fft)[None, :]
        )
        frames = x[idx] * self.window[None, :]
        spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2  # [frames, n_freqs]
        mel = spec @ self.fb  # [frames, n_mels]
        return mel.T.astype(np.float32)


def log_normalize(x):
    """log(x + 1e-6), then per-utterance standardization (audioset.py:17-21)."""
    x = np.log(x + 1e-6)
    mean = x.mean()
    std = x.std()
    return (x - mean) / (std + 1e-6)


class FrequencyMasking:
    """SpecAugment frequency mask (torchaudio semantics: width uniform in
    [0, param], zeroed band)."""

    def __init__(self, freq_mask_param):
        self.param = freq_mask_param

    def __call__(self, x, rng=None):
        rng = rng or np.random
        f = rng.randint(0, self.param + 1)
        if f == 0 or f >= x.shape[0]:
            return x
        f0 = rng.randint(0, x.shape[0] - f + 1)
        x = x.copy()
        x[f0 : f0 + f, :] = 0.0
        return x


class TimeMasking:
    def __init__(self, time_mask_param):
        self.param = time_mask_param

    def __call__(self, x, rng=None):
        rng = rng or np.random
        t = rng.randint(0, self.param + 1)
        if t == 0 or t >= x.shape[1]:
            return x
        t0 = rng.randint(0, x.shape[1] - t + 1)
        x = x.copy()
        x[:, t0 : t0 + t] = 0.0
        return x
