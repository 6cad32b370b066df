"""The OTA aligner ("One TTS Alignment To Rule Them All",
arXiv:2108.10447) in plain PyTorch: its weights drawn from the seed, its
forward pass with the losses, and AdamW.

    keys    = TextEncoder(tokens)      embedding, conv3 relu conv3 relu conv1
    queries = MelEncoder(mel)          conv3 relu conv3 relu conv1
    energy  = -temperature * |q - k|^2 (pause-aware: one learned pause key
              appended to the keys as an extra label)
    log_attn = log_softmax over the labels (+ beta-binomial prior)
    loss_forward_sum = mean over items of nll / t_y
    loss_bin = mean over items of -sum(hard * log_attn) / t_y, hard the
               float32 Viterbi path through the lattice with the prior
    loss_recon = |softmax(energy) @ Linear(keys) - mel|^2 over real frames
                 / n_mels

With pauses the label log-probabilities are spread onto 2 t_x + 1
states: token j onto state 2j+1, the pause label onto every even state,
and the prior onto the states by the "bridge" rule (a pause between
tokens j-1 and j takes logaddexp of their priors minus log 2).

`precision` is the arithmetic of the encoders: "float32" (TF32 off),
"tf32" (TF32 on), "bfloat16" (the encoders, the energy product's inputs
and the decoder in bfloat16 with float32 weights, everything after the
energies in float32) or "fp8" (as bfloat16, with each convolution's
input and weight and the energy product's inputs rounded to float8 e4m3
under a per-tensor scale).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from . import viterbi
from .dp import NEG, forward_sum_nll, forward_sum_skip_nll

FP8_MAX = 448.0     # largest finite float8 e4m3fn


def param_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    """Every weight, in the order in which the weights are drawn."""
    V, M, D, H = cfg["vocab_size"], cfg["n_mels"], cfg["dim"], cfg["hidden"]
    out = [("pause_key", (D,))] if cfg["model_pauses"] else []
    out.append(("text_encoder.embed.weight", (V, H)))
    for enc, c_in in (("text_encoder", H), ("mel_encoder", M)):
        for i, (c_out, cin, k) in enumerate(((H, c_in, 3), (H, H, 3),
                                             (D, H, 1))):
            out += [(f"{enc}.convs.conv{i}.weight", (c_out, cin, k)),
                    (f"{enc}.convs.conv{i}.bias", (c_out,))]
    if cfg["use_recon"]:
        out += [("mel_decoder.weight", (M, D)), ("mel_decoder.bias", (M,))]
    return out


def init_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Weights from a CPU generator seeded with `seed`, drawn in order:
    normal with variance 1/fan-in (the embedding's fan-in its width),
    vectors zero. Made on the host and copied, as the weights are few."""
    g = torch.Generator().manual_seed(seed)
    params = {}
    for name, shape in param_shapes(cfg):
        if len(shape) == 1:
            p = torch.zeros(shape)
        else:
            fan_in = shape[1] if name.endswith("embed.weight") \
                else math.prod(shape[1:])
            p = torch.randn(shape, generator=g) * fan_in ** -0.5
        params[name] = p.to(device)
    return params


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuBLAS and cuDNN on or off, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, in x's dtype."""
    scale = FP8_MAX / x.detach().abs().amax().float().clamp(min=1e-12)
    q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


def _conv_stack(params, prefix, x, mask, dt, fp8):
    m = mask[:, None, :].to(dt)
    x = x.to(dt).transpose(1, 2)
    for i in range(3):
        w = params[f"{prefix}.convs.conv{i}.weight"].to(dt)
        b = params[f"{prefix}.convs.conv{i}.bias"].to(dt)
        x = x * m
        if fp8:
            x, w = fp8_round(x), fp8_round(w)
        x = F.conv1d(x, w, b, padding=w.shape[-1] // 2)
        if i != 2:
            x = torch.relu(x)
    return (x * m).transpose(1, 2)


def log_beta_binomial_prior(t_x, t_y, T_x, T_y, omega=1.0):
    """log BetaBinomial(x; n=t_x-1, a=omega*y, b=omega*(t_y+1-y)) for frame
    y (1-based) in closed form, [B, T_y, T_x]; NEG outside the item."""
    dev = t_x.device
    n = (t_x.double() - 1.0)[:, None, None]
    ty = t_y.double()[:, None, None]
    k = torch.arange(T_x, dtype=torch.float64, device=dev)[None, None, :]
    y = torch.arange(1, T_y + 1, dtype=torch.float64, device=dev)[None, :,
                                                                  None]
    a = omega * y
    b = omega * (ty + 1.0 - y)
    ok = (k <= n) & (y <= ty)
    b = torch.where(ok, b, 1.0)
    k = torch.where(ok, k, 0.0)
    lg = torch.lgamma
    logp = (lg(n + 1) - lg(k + 1) - lg(n - k + 1)
            + lg(k + a) + lg(n - k + b) - lg(n + a + b)
            - lg(a) - lg(b) + lg(a + b))
    return torch.where(ok, logp, NEG).float()


def bridge_prior(prior: torch.Tensor, t_x: torch.Tensor) -> torch.Tensor:
    """The token prior [B, T_y, T_x] on 2 T_x + 1 states: token j keeps its
    own; the pause before token j takes logaddexp(prior[j-1], prior[j]) -
    log 2 with j clamped into [0, t_x-1] (so the edge pauses take their
    one neighbour's)."""
    B, T_y, T_x = prior.shape
    ss = torch.arange(2 * T_x + 1, device=prior.device)
    last = (t_x.long() - 1).clamp(min=0)[:, None]
    j = torch.minimum(ss[None, :] // 2, last)
    jp = torch.minimum((ss[None, :] // 2 - 1).clamp(min=0), last)
    take = lambda idx: prior.gather(2, idx[:, None, :].expand(B, T_y, -1))
    own, prev = take(j), take(jp)
    bridge = torch.logaddexp(own, prev) - math.log(2.0)
    return torch.where((ss % 2 == 0)[None, None, :], bridge, own)


def forward(params: dict, cfg: dict, batch: dict, precision: str) -> dict:
    """The forward pass on one padded batch of device tensors (tokens,
    mel, text_lengths, mel_lengths). Returns loss_forward_sum and
    loss_recon (0-d), the log-attention `log_attn` and the lattice
    `logp_with_prior` [B, T_y, T] (float32, with the prior), and `nll`
    [B]."""
    tokens, mel = batch["tokens"].long(), batch["mel"].float()
    t_x, t_y = batch["text_lengths"].long(), batch["mel_lengths"].long()
    B, T_x = tokens.shape
    T_y = mel.shape[1]
    low = precision in ("bfloat16", "fp8")
    dt = torch.bfloat16 if low else torch.float32
    fp8 = precision == "fp8"
    text_mask = (torch.arange(T_x, device=mel.device)[None] < t_x[:, None])
    mel_mask = (torch.arange(T_y, device=mel.device)[None] < t_y[:, None])
    with tf32(precision == "tf32"):
        x = params["text_encoder.embed.weight"][tokens].to(dt)
        keys = _conv_stack(params, "text_encoder", x, text_mask, dt, fp8)
        labels_mask = text_mask
        if cfg["model_pauses"]:
            keys = torch.cat([keys, params["pause_key"].to(dt)
                              .expand(B, 1, -1)], dim=1)
            labels_mask = torch.cat([text_mask, text_mask.new_ones(B, 1)],
                                    dim=1)
        queries = _conv_stack(params, "mel_encoder", mel, mel_mask, dt, fp8)
        q, k = (fp8_round(queries), fp8_round(keys)) if fp8 else \
            (queries, keys)
        q, k = q.float(), k.float()
        dist = (q * q).sum(-1, keepdim=True) - 2.0 * torch.bmm(
            q, k.transpose(1, 2)) + (k * k).sum(-1)[:, None, :]
        energy = -cfg["temperature"] * dist
        energy = torch.where(labels_mask[:, None, :], energy, -1e9)
        log_labels = torch.log_softmax(energy, dim=-1)
        prior = log_beta_binomial_prior(t_x, t_y, T_x, T_y,
                                        cfg["prior_omega"]) \
            if cfg["use_prior"] else 0.0
        if cfg["model_pauses"]:
            S = 2 * T_x + 1
            ss = torch.arange(S, device=mel.device)
            label_of_state = torch.where(ss % 2 == 1, (ss - 1) // 2, T_x)
            log_attn = log_labels[:, :, label_of_state]
            if cfg["use_prior"]:
                prior = bridge_prior(prior, t_x)
            live = ss[None, :] < (2 * t_x + 1)[:, None]
        else:
            log_attn = log_labels
            live = text_mask
        logp = (log_attn + prior).clamp(min=NEG)
        logp = torch.where(live[:, None, :], logp, NEG)
        if cfg["model_pauses"]:
            nll = forward_sum_skip_nll(logp, t_x, t_y,
                                       cfg["pause_enter_cost"])
        else:
            nll = forward_sum_nll(logp, t_x, t_y)
        loss_fs = torch.mean(nll / t_y.clamp(min=1))
        loss_recon = torch.zeros((), device=mel.device)
        if cfg["use_recon"]:
            w, b = params["mel_decoder.weight"], params["mel_decoder.bias"]
            decoded = F.linear(keys, w.to(dt), b.to(dt)).float()
            recon = torch.bmm(torch.exp(log_labels), decoded)
            fm = mel_mask[..., None].float()
            loss_recon = (torch.sum(fm * (recon - mel) ** 2)
                          / fm.sum().clamp(min=1) / cfg["n_mels"])
    return {"loss_forward_sum": loss_fs, "loss_recon": loss_recon,
            "log_attn": log_attn, "logp_with_prior": logp, "nll": nll}


def train_loss(params: dict, cfg: dict, batch: dict, precision: str):
    """(loss, outputs): the training objective with the binarisation
    loss at weight 1: forward-sum, binarisation and reconstruction. The
    outputs gain `loss_bin`, and the hard path's `durations` (with pauses
    also `pause_durations`)."""
    out = forward(params, cfg, batch, precision)
    t_y = batch["mel_lengths"].long()
    lp = out["logp_with_prior"].detach()
    occ = viterbi.float32_occupancy(lp, batch["text_lengths"], t_y,
                                    cfg["model_pauses"],
                                    cfg["pause_enter_cost"])
    hard = viterbi.path_mask(occ, t_y, lp.shape[1])
    ce = -torch.sum(hard * out["log_attn"], dim=(1, 2))
    out["loss_bin"] = torch.mean(ce / t_y.clamp(min=1))
    occ = occ.float()               # frames a state, as the program's
    if cfg["model_pauses"]:
        out["durations"], out["pause_durations"] = occ[:, 1::2], occ[:, 0::2]
    else:
        out["durations"] = occ
    loss = out["loss_forward_sum"] + out["loss_bin"] + out["loss_recon"]
    return loss, out


@torch.no_grad()
def adamw_step(params: dict, grads: dict, state: dict, lr: float,
               weight_decay: float = 1e-6, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8) -> None:
    """One AdamW update in place (decoupled decay of the weight before
    the update; bias-corrected moments). `state` holds the moments and
    the count."""
    t = state["t"] = state.get("t", 0) + 1
    for name, p in params.items():
        g = grads[name]
        m = state.setdefault(("m", name), torch.zeros_like(p))
        v = state.setdefault(("v", name), torch.zeros_like(p))
        p.mul_(1.0 - lr * weight_decay)
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v / (1.0 - b2 ** t)).sqrt() + eps
        p.sub_(lr * (m / (1.0 - b1 ** t)) / denom)
