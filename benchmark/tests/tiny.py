"""A copy of the benchmark folder with tiny cells beside the real ones,
for runs on the CPU."""
from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_MODEL = {"vocab_size": 12, "n_mels": 8, "dim": 8, "hidden": 12}
TINY_TRAIN = {"batch_size": 4, "utterances": 12,
              "tokens": {"min": 3, "max": 6},
              "frames": {"per_token": {"min": 2, "max": 4}, "min": 6,
                         "max": 24},
              "text_buckets": [8], "mel_buckets": [16, 24], "log_every": 5,
              "sizes_seed": 3}


def make(root: str, cells=("ota_f32.train_long",
                           "ota_pauses_bf16.train_long",
                           "ota_f32.align_long")) -> str:
    """Copy the benchmark to `root`/benchmark, shrink the configurations
    and mixes of `cells` into tiny ones of the same names, and return the
    copy's BENCHMARK.json."""
    dst = os.path.join(root, "benchmark")
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        spec = json.load(f)
    for w in spec["workloads"]:
        if w["name"] not in cells:
            continue
        cfile = os.path.join(dst, "configs", f"{w['config']}.json")
        with open(cfile) as f:
            conf = json.load(f)
        conf.update(TINY_MODEL)
        with open(cfile, "w") as f:
            json.dump(conf, f)
        tfile = os.path.join(dst, "traffic", f"{w['traffic']}.json")
        with open(tfile) as f:
            mix = json.load(f)
        mix.update({k: v for k, v in TINY_TRAIN.items()
                    if k != "log_every" or "log_every" in mix})
        with open(tfile, "w") as f:
            json.dump(mix, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path
