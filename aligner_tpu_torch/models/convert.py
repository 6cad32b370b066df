"""Flax param tree -> `OTAAligner`, `MoBoAligner` or `RoMoAligner`
state_dict.

The JAX package's model params (numpy arrays, e.g. from
`model.init(...)["params"]` or a restored checkpoint) become the port's
`state_dict`:

* a conv `kernel` [k, in, out] becomes a Conv1d weight [out, in, k];
* a Dense `kernel` [in, out] becomes a Linear weight [out, in];
* `embed/embedding` [V, H] is copied as it is; biases and the pause
  model's `pause_key` too.

Unknown or missing keys raise, so a tree from another configuration (a
pause tree into a MoBo config, a tree without the reconstruction decoder
into a config with it) never loads half-way. The three families share
their encoders' keys; MoBo and RoMo have no `pause_key`.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .mobo import MoBoConfig
from .ota import OTAConfig
from .romo import RoMoConfig

ModelConfig = OTAConfig | MoBoConfig | RoMoConfig


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _expected_keys(config: ModelConfig) -> dict[str, str]:
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
    if getattr(config, "model_pauses", False):
        keys["pause_key"] = "pause_key"
    return keys


def flax_to_state_dict(params: Mapping,
                       config: ModelConfig) -> dict[str, torch.Tensor]:
    """Convert a flax OTAAligner, MoBoAligner or RoMoAligner param tree
    for `config` (an OTAConfig, MoBoConfig or RoMoConfig). A pause tree
    does not load into a non-pause config, nor the other way round."""
    if not isinstance(config, ModelConfig):
        raise TypeError(f"expected an OTAConfig, MoBoConfig or RoMoConfig, "
                        f"got {type(config).__name__}")
    flat = _flatten(params)
    expected = _expected_keys(config)
    unknown = sorted(set(flat) - set(expected))
    missing = sorted(set(expected) - set(flat))
    if unknown or missing:
        raise KeyError(f"flax params do not match "
                       f"{type(config).__name__}: unknown "
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
