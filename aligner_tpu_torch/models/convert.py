"""Flax param tree -> `OTAAligner` state_dict.

The JAX package's OTAAligner params (numpy arrays, e.g. from
`model.init(...)["params"]` or a restored checkpoint) become the port's
`state_dict`:

* a conv `kernel` [k, in, out] becomes a Conv1d weight [out, in, k];
* a Dense `kernel` [in, out] becomes a Linear weight [out, in];
* `embed/embedding` [V, H] is copied as it is; biases and the pause
  model's `pause_key` too.

Unknown or missing keys raise, so a tree from another model family or
configuration never loads half-way.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .ota import OTAConfig


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _expected_keys(config: OTAConfig) -> dict[str, str]:
    """flax path -> state_dict key."""
    keys = {"text_encoder/embed/embedding": "text_encoder.embed.weight"}
    for enc in ("text_encoder", "mel_encoder"):
        for i in range(3):
            for leaf, name in (("kernel", "weight"), ("bias", "bias")):
                keys[f"{enc}/convs/conv{i}/{leaf}"] = \
                    f"{enc}.convs.conv{i}.{name}"
    if config.use_recon:
        keys["mel_decoder/kernel"] = "mel_decoder.weight"
        keys["mel_decoder/bias"] = "mel_decoder.bias"
    if config.model_pauses:
        keys["pause_key"] = "pause_key"
    return keys


def flax_to_state_dict(params: Mapping,
                       config: OTAConfig) -> dict[str, torch.Tensor]:
    """Convert a flax OTAAligner param tree for `config`. A pause tree
    does not load into a non-pause config, nor the other way round."""
    flat = _flatten(params)
    expected = _expected_keys(config)
    unknown = sorted(set(flat) - set(expected))
    missing = sorted(set(expected) - set(flat))
    if unknown or missing:
        raise KeyError(f"flax params do not match OTAConfig: unknown "
                       f"{unknown}, missing {missing}")
    state = {}
    for path, key in expected.items():
        arr = np.asarray(flat[path], dtype=np.float32)
        if path.endswith("/kernel") and arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)          # [k, in, out] -> [out, in, k]
        elif path.endswith("/kernel"):
            arr = arr.T                           # [in, out] -> [out, in]
        state[key] = torch.tensor(arr)
    return state
