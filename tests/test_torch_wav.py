"""The port's wav front end against aligner_tpu on the same inputs: the
log-mel and its filterbank, wav reading, the corpus loader, tokenizers,
TextGrids and bucketing.

The port computes the STFT with torch.stft and the JAX package as a
product with a windowed DFT basis, so the log-mel is held at atol 1e-4,
not bit for bit; everything else is held equal.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from aligner_tpu import data as jdata
from aligner_tpu.ops import mel as jmel
from aligner_tpu_torch import data as tdata
from aligner_tpu_torch.ops import mel as tmel

MEL_ATOL = 1e-4

CONFIGS = {
    "default": {},
    "hop128": {"hop_length": 128},
    "win512": {"n_fft": 512, "win_length": 512},
    "no_center": {"center": False},
    "htk": {"htk": True},
    "short_window": {"win_length": 800},
    "magnitude": {"power": 1.0},
    "fmax_nyquist": {"fmax": None},
}


def configs(name):
    kw = CONFIGS[name]
    return jmel.MelConfig(**kw), tmel.MelConfig(**kw)


def waves(length, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, length)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("length", [300, 1024, 5000, 22050])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_log_mel_matches_jax(name, length):
    """300 samples is shorter than the centred pad (512): the reflection
    repeats, as jnp.pad's does."""
    jc, tc = configs(name)
    wav = waves(length, seed=length)
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wav), jc))
    got = tmel.log_mel_spectrogram(torch.from_numpy(wav), tc)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MEL_ATOL)


@pytest.mark.parametrize("name", ["default", "hop128", "win512", "no_center",
                                  "magnitude"])
def test_spectrogram_matches_jax(name):
    jc, tc = configs(name)
    wav = waves(4096, seed=3)
    want = np.asarray(jmel.spectrogram(jnp.asarray(wav), jc))
    got = tmel.spectrogram(torch.from_numpy(wav), tc).numpy()
    assert got.shape == want.shape
    # Power values reach ~1e4: hold them relative to their size.
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=MEL_ATOL * np.abs(want).max())


def float64_log_mel(wav, cfg):
    """numpy float64 reference: reflect pad, periodic Hann window of
    win_length centred in n_fft, rfft, power, mel, floored log."""
    x = np.pad(wav.astype(np.float64), ((0, 0), (cfg.n_fft // 2,) * 2),
               mode="reflect") if cfg.center else wav.astype(np.float64)
    n = 1 + (x.shape[1] - cfg.n_fft) // cfg.hop_length
    win = np.zeros(cfg.n_fft)
    off = (cfg.n_fft - cfg.win_length) // 2
    win[off:off + cfg.win_length] = 0.5 - 0.5 * np.cos(
        2 * np.pi * np.arange(cfg.win_length) / cfg.win_length)
    idx = np.arange(n)[:, None] * cfg.hop_length + np.arange(cfg.n_fft)
    power = np.abs(np.fft.rfft(x[:, idx] * win, axis=-1)) ** 2
    mel = power @ tmel.mel_filterbank(cfg).astype(np.float64)
    return np.log(np.maximum(mel, cfg.log_floor))


@pytest.mark.parametrize("name", ["default", "hop128", "no_center"])
def test_log_mel_near_silence_matches_float64(name):
    """Bins just above the 1e-5 floor (a quiet tone between silences):
    the port computes in float64, so it stays within float32 rounding of
    the exact log-mel where a float32 STFT is off by 1e-4 or more."""
    _, tc = configs(name)
    rng = np.random.default_rng(11)
    t = np.arange(12000) / 22050
    wav = (0.5 * np.sin(2 * np.pi * 440 * t) * (t > 0.15) * (t < 0.35)
           + 1e-4 * rng.standard_normal(t.shape)).astype(np.float32)[None]
    got = tmel.log_mel_spectrogram(torch.from_numpy(wav), tc).numpy()
    np.testing.assert_allclose(got, float64_log_mel(wav, tc), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("length", [1, 2, 3, 300, 513, 2000])
def test_reflect_pad_repeats_as_numpy_does(length):
    wav = waves(length, seed=length)
    want = np.pad(wav, ((0, 0), (512, 512)), mode="reflect")
    got = tmel.reflect_pad(torch.from_numpy(wav), 512).numpy()
    np.testing.assert_array_equal(got, want)


def test_no_center_wav_shorter_than_a_window_gives_no_frames():
    jc, tc = configs("no_center")
    wav = waves(300)
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wav), jc))
    got = tmel.log_mel_spectrogram(torch.from_numpy(wav), tc)
    assert want.shape == got.shape == (2, 0, 80)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_filterbank_and_lengths_equal(name):
    jc, tc = configs(name)
    np.testing.assert_array_equal(tmel.mel_filterbank(tc),
                                  jmel.mel_filterbank(jc))
    lengths = np.array([1, 300, 1023, 1024, 1025, 22050, 100000])
    np.testing.assert_array_equal(
        tmel.mel_lengths_from_wav_lengths(torch.from_numpy(lengths),
                                          tc).numpy(),
        np.asarray(jmel.mel_lengths_from_wav_lengths(jnp.asarray(lengths),
                                                     jc)))
    assert tmel.mel_lengths_from_wav_lengths(5000, tc) == \
        jmel.mel_lengths_from_wav_lengths(5000, jc)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def test_log_mel_frames_match_their_lengths():
    cfg = tmel.MelConfig()
    wav = waves(22050, batch=1)
    mel = tmel.log_mel_spectrogram(torch.from_numpy(wav), cfg)
    assert mel.shape[1] == tmel.mel_lengths_from_wav_lengths(22050, cfg)
    assert torch.isfinite(mel).all()


TEXTS = ["Hello, TTS 42!", "é and ü", "HH AH0 L OW1", "W ER1  L D ",
         "ab cd 0", "quote \" here"]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizers_equal(text):
    jt, tt = jdata.CharTokenizer(), tdata.CharTokenizer()
    np.testing.assert_array_equal(tt.encode(text), jt.encode(text))
    assert tt.encode(text).dtype == np.int32
    assert tt.labels(text) == jt.labels(text)
    assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    assert tt.vocab_size == jt.vocab_size
    jp = jdata.PhoneTokenizer.from_corpus(TEXTS[2:4])
    tp = tdata.PhoneTokenizer.from_corpus(TEXTS[2:4])
    assert tp.phones == jp.phones and tp.vocab_size == jp.vocab_size
    np.testing.assert_array_equal(tp.encode(text), jp.encode(text))
    assert tp.labels(text) == jp.labels(text)
    assert tp.decode(tp.encode(text)) == jp.decode(jp.encode(text))


@pytest.mark.parametrize("durations,labels", [
    ([2, 3, 1], ["a", "b", 'c"q']),
    ([5], [""]),
    ([], []),
    ([1, 0, 7, 12], ["HH", "", "AH0", "L"]),
])
def test_textgrid_files_equal(tmp_path, durations, labels):
    for hop, sr in ((256, 22050), (128, 16000)):
        jdata.write_textgrid(str(tmp_path / "j.TextGrid"), durations, labels,
                             hop, sr)
        tdata.write_textgrid(str(tmp_path / "t.TextGrid"), durations, labels,
                             hop, sr)
        assert (tmp_path / "t.TextGrid").read_bytes() == \
            (tmp_path / "j.TextGrid").read_bytes()
        assert tdata.durations_to_intervals(durations, labels, hop, sr) == \
            jdata.durations_to_intervals(durations, labels, hop, sr)


@pytest.mark.parametrize("kind", ["int16", "int32", "uint8", "float32",
                                  "stereo"])
def test_read_wav_equal(tmp_path, kind):
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.9, 0.9, 3000)
    data = {"int16": (x * 32767).astype(np.int16),
            "int32": (x * 2 ** 31).astype(np.int32),
            "uint8": (x * 127 + 128).astype(np.uint8),
            "float32": x.astype(np.float32),
            "stereo": np.stack([x, -x / 2], 1).astype(np.float32)}[kind]
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 16000, data)
    sr_j, wav_j = jdata.read_wav(path)
    sr_t, wav_t = tdata.read_wav(path)
    assert sr_t == sr_j == 16000
    assert wav_t.dtype == np.float32 and wav_t.ndim == 1
    np.testing.assert_array_equal(wav_t, wav_j)


def write_corpus(root, rates, texts, seed=0, missing=()):
    os.makedirs(root / "wavs")
    rng = np.random.default_rng(seed)
    lines = []
    for i, (sr, text) in enumerate(zip(rates, texts)):
        utt = f"u{i}"
        lines.append(f"{utt}|normalized|{text}")
        if i in missing:
            continue
        n = int(rng.integers(200, sr // 2))
        t = np.arange(n) / sr
        wav = (0.4 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
               + 0.05 * rng.standard_normal(n))
        wavfile.write(str(root / "wavs" / f"{utt}.wav"), sr,
                      (wav * 32767).astype(np.int16))
    (root / "metadata.csv").write_text("\n".join(lines) + "\n\n")
    return str(root)


@pytest.mark.parametrize("tokenizer", ["char", "phone"])
@pytest.mark.parametrize("limit", [None, 4])
def test_load_corpus_matches_jax(tmp_path, tokenizer, limit):
    """Same items, ids and tokens; mels at atol 1e-4 against JAX's
    bucketed loader. Rows at 16 and 24 kHz are resampled; one row's wav is
    missing and is skipped; one utterance is shorter than the centred
    pad."""
    texts = ["HH AH0 L OW1", "W ER1 L D", "ab cd 0", "AH0 B", "x y z",
             "L OW1 L"]
    root = write_corpus(tmp_path, [22050, 16000, 22050, 24000, 22050,
                                   22050], texts, missing=(2,))
    if tokenizer == "phone":
        jt = jdata.PhoneTokenizer.from_corpus(texts)
        tt = tdata.PhoneTokenizer.from_corpus(texts)
    else:
        jt, tt = jdata.CharTokenizer(), tdata.CharTokenizer()
    want = list(jdata.load_corpus(root, tokenizer=jt, limit=limit))
    got = list(tdata.load_corpus(root, tokenizer=tt, limit=limit,
                                 device="cpu"))
    assert [it["utt_id"] for it in got] == [it["utt_id"] for it in want]
    assert len(got) == (4 if limit else 5)
    assert list(tdata.load_metadata(root)) == list(jdata.load_metadata(root))
    for a, b in zip(got, want):
        assert a["text"] == b["text"]
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["mel"].dtype == np.float32
        assert a["mel"].shape == b["mel"].shape
        np.testing.assert_allclose(a["mel"], b["mel"], rtol=0,
                                   atol=MEL_ATOL)
    # bucketing both loaders' items gives the same batches
    for seed in (None, 3):
        jb = list(jdata.bucket_batches(want, 2, shuffle_seed=seed))
        tb = list(tdata.bucket_batches(got, 2, shuffle_seed=seed))
        assert len(tb) == len(jb)
        for x, y in zip(tb, jb):
            assert x.keys() == y.keys()
            for k in ("tokens", "text_lengths", "mel_lengths"):
                np.testing.assert_array_equal(x[k], y[k])
            np.testing.assert_allclose(x["mel"], y["mel"], rtol=0,
                                       atol=MEL_ATOL)


def test_load_corpus_levers_and_zero_tokens(tmp_path):
    root = write_corpus(tmp_path, [22050, 22050], ["AH0 B", "   "])
    cfg_j = jmel.MelConfig(hop_length=128, n_fft=512, win_length=512,
                           center=False)
    cfg_t = tmel.MelConfig(hop_length=128, n_fft=512, win_length=512,
                           center=False)
    want = list(jdata.load_corpus(root, mel_config=cfg_j, limit=1))
    got = list(tdata.load_corpus(root, mel_config=cfg_t, limit=1,
                                 device="cpu"))
    np.testing.assert_allclose(got[0]["mel"], want[0]["mel"], rtol=0,
                               atol=MEL_ATOL)
    tok = tdata.PhoneTokenizer(phones=("AH0", "B"))
    with pytest.raises(ValueError, match="zero tokens"):
        list(tdata.load_corpus(root, tokenizer=tok, device="cpu"))
