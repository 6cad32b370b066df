"""The traffic generator's lengths against each mix file's parameters."""
import json
import os

import numpy as np
import pytest

from harness import traffic

MIXES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "traffic")
SEED = 2**31 + 12345          # larger than 32 signed bits hold


def mix(name, utterances=400):
    with open(os.path.join(MIXES, f"{name}.json")) as f:
        m = json.load(f)
    m["utterances"] = utterances
    return m


def lengths(corpus):
    t_x = np.array([len(u["tokens"]) for u in corpus])
    t_y = np.array([u["mel"].shape[0] for u in corpus])
    return t_x, t_y


@pytest.mark.parametrize("name", ["train_long", "train_long_pauses",
                                  "align_long"])
def test_long_mixes(name):
    corpus = traffic.make_corpus(mix(name), SEED, 76, 80)
    t_x, t_y = lengths(corpus)
    assert t_x.min() >= 64 and t_x.max() <= 128
    assert t_y.min() >= 1024 and t_y.max() <= 2048
    # about 16 frames a token where the [1024, 2048] hold leaves it free
    free = (t_y > 1024) & (t_y < 2048)
    assert 15.0 < np.mean(t_y[free] / t_x[free]) < 17.0
    assert abs(t_x.mean() - 96) < 4
    for u in corpus:
        assert (u["durations"] >= 1).all()
        assert u["durations"].sum() + u["pause_durations"].sum() == \
            u["mel"].shape[0]
        assert u["tokens"].min() >= 1 and u["tokens"].max() <= 75


def test_pause_mix_draws_pauses_at_its_rate():
    m = mix("train_long_pauses")
    corpus = traffic.make_corpus(m, SEED, 76, 80)
    gaps = np.concatenate([u["pause_durations"] for u in corpus])
    assert abs(np.mean(gaps > 0) - m["pauses"]["prob"]) < 0.02
    assert gaps[gaps > 0].min() >= m["pauses"]["min"]
    assert gaps.max() <= m["pauses"]["max"]
    plain = traffic.make_corpus(mix("train_long"), SEED, 76, 80)
    assert all((u["pause_durations"] == 0).all() for u in plain)


def test_ljspeech_mix():
    corpus = traffic.make_corpus(mix("train_ljspeech", 2000), SEED, 76, 80)
    t_x, t_y = lengths(corpus)
    assert t_y.min() >= 95 and t_y.max() <= 870
    assert abs(t_y.mean() - 566) < 15            # LJSpeech's 6.57 s mean
    assert t_x.max() <= 160 and (t_x <= t_y).all()
    assert abs(np.median(t_y / t_x) - 5.7) < 0.1  # about 15 chars a second


def test_same_seed_same_corpus_and_frames_share_the_prototype():
    m = mix("train_long_pauses", 8)
    a = traffic.make_corpus(m, SEED, 76, 80)
    b = traffic.make_corpus(m, SEED, 76, 80)
    c = traffic.make_corpus(m, SEED + 1, 76, 80)
    for u, v in zip(a, b):
        assert np.array_equal(u["mel"], v["mel"])
        assert np.array_equal(u["tokens"], v["tokens"])
    assert not np.array_equal(a[0]["tokens"][:10], c[0]["tokens"][:10])
    # a token's frames sit around its prototype: frames of one token are
    # closer to each other than to the next token's
    u = a[0]
    d0, d1 = int(u["pause_durations"][0]), int(u["durations"][0])
    first = u["mel"][d0:d0 + d1]
    assert np.linalg.norm(first - first.mean(0), axis=1).mean() < \
        np.linalg.norm(first.mean(0) - u["mel"][d0 + d1 + int(
            u["pause_durations"][1])])


def test_spread_keeps_each_token_a_frame():
    rng = np.random.default_rng(0)
    for total, t_x in [(5, 5), (100, 7), (2048, 128)]:
        d = traffic.spread(rng, total, t_x)
        assert d.sum() == total and d.min() >= 1 and len(d) == t_x


@pytest.mark.parametrize("name", ["train_long", "train_ljspeech",
                                  "align_long"])
def test_every_seed_gets_the_same_sizes(name):
    m = mix(name, 50)
    a = traffic.make_corpus(m, SEED, 76, 80)
    b = traffic.make_corpus(m, SEED + 1, 76, 80)
    assert [(len(u["tokens"]), u["mel"].shape[0]) for u in a] == \
        [(len(u["tokens"]), u["mel"].shape[0]) for u in b]
    assert not np.array_equal(a[0]["tokens"], b[0]["tokens"])
