"""The encoders' convolution route (`aligner_tpu_torch/ops/conv.py`): the
GEMM backward against `F.conv1d`'s own autograd and against finite
differences, the route each call takes, and the column-parallel layer
built from it against the whole layer.

This file imports no JAX, so the tests marked `cuda` also run on a GPU
machine that has none (the repo's conftest imports jax, hence
--noconftest):

    python -m pytest --noconftest -p no:cacheprovider -o "markers=cuda: gpu" tests/test_torch_conv_route.py
"""
import pytest
import torch
import torch.nn.functional as F

from aligner_tpu_torch.models.encoders import MelEncoder, TextEncoder
from aligner_tpu_torch.ops import conv as conv_ops
from aligner_tpu_torch.ops.conv import Conv1dGemmBackward

# float32 sums of a few hundred terms, reordered: well inside 1e-5 of the
# largest entry (measured 2.6e-7 on these cases)
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def layer(seed, B, c_in, c_out, T, k, *, frames_last=True, masked=False,
          device="cpu", dtype=torch.float32):
    """x [B, c_in, T] (as the encoders lay it out: [B, T, C] transposed,
    times the mask), weight, bias and an output gradient."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, T, c_in, generator=g).transpose(1, 2) if frames_last
         else torch.randn(B, c_in, T, generator=g))
    dy = torch.randn(B, c_out, T, generator=g)
    if masked:
        lengths = torch.randint(1, T + 1, (B,), generator=g)
        lengths[0] = T
        mask = (torch.arange(T) < lengths[:, None]).to(x.dtype)[:, None, :]
        x, dy = x * mask, dy * mask
    w = torch.randn(c_out, c_in, k, generator=g) * (c_in * k) ** -0.5
    b = torch.randn(c_out, generator=g)
    return tuple(t.to(device, dtype) for t in (x, w, b, dy))


def grads(fn, x, w, b, dy, need_x=True):
    x = x.detach().requires_grad_(need_x)
    w, b = w.detach().requires_grad_(), b.detach().requires_grad_()
    y = fn(x, w, b)
    return (y, *torch.autograd.grad(y, [x, w, b] if need_x else [w, b], dy))


def assert_near(got, want):
    scale = float(want.detach().abs().max())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * scale)


# (B, c_in, c_out, T, k, frames_last, masked, need_x)
CASES = {
    "k3": (3, 8, 8, 17, 3, True, False, True),
    "k1": (3, 12, 7, 17, 1, True, False, True),
    "k3_masked": (4, 6, 10, 23, 3, True, True, True),
    "k1_masked": (4, 10, 6, 23, 1, True, True, True),
    "k3_t1": (2, 5, 6, 1, 3, True, False, True),
    "k3_t2": (2, 5, 6, 2, 3, True, False, True),
    "k1_t1": (2, 5, 6, 1, 1, True, False, True),
    "k3_b1": (1, 7, 4, 9, 3, True, False, True),
    "k3_channels_first": (2, 6, 9, 11, 3, False, False, True),
    "k5": (2, 4, 6, 13, 5, True, True, True),
    "k3_no_input_grad": (3, 8, 12, 15, 3, True, True, False),
    "k1_no_input_grad": (3, 8, 12, 15, 1, True, True, False),
    "mel_widths": (2, 80, 256, 40, 3, True, True, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gemm_backward_matches_conv1d_autograd(case):
    """Output bit for bit (the forward is F.conv1d), and every gradient
    asked for within float32 rounding of F.conv1d's autograd; the input
    gradient is neither computed nor returned when x needs none."""
    B, c_in, c_out, T, k, frames_last, masked, need_x = CASES[case]
    x, w, b, dy = layer(0, B, c_in, c_out, T, k, frames_last=frames_last,
                        masked=masked)
    p = k // 2
    want = grads(lambda x, w, b: F.conv1d(x, w, b, padding=p), x, w, b, dy,
                 need_x)
    got = grads(lambda x, w, b: Conv1dGemmBackward.apply(x, w, b, (p,)),
                x, w, b, dy, need_x)
    assert torch.equal(got[0], want[0])
    assert len(got) == len(want) == (4 if need_x else 3)
    for g, wnt in zip(got[1:], want[1:]):
        assert g.shape == wnt.shape
        assert_near(g, wnt)
    assert got[-2].stride() == w.stride()      # the weight's own layout


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("with_bias", [True, False])
def test_gemm_backward_gradcheck(k, with_bias):
    """Finite differences in float64, masked frames included."""
    x, w, b, _ = layer(1, 2, 3, 4, 6, k, masked=True, dtype=torch.float64)
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
    args = (x, w, b if with_bias else None)
    assert torch.autograd.gradcheck(
        lambda x, w, b: Conv1dGemmBackward.apply(x, w, b, k // 2), args)


def test_gemm_backward_takes_only_same_padding():
    x, w, b, _ = layer(2, 2, 3, 4, 6, 3)
    with pytest.raises(ValueError, match="padding"):
        Conv1dGemmBackward.apply(x, w, b, 0)


def column_parallel(conv_fn, x, w, b, shards):
    """The column-parallel layer of `parallel/tensor.py` in one process:
    each rank's output channels through the convolution without the bias,
    gathered along the channels, the bias added after; autograd sums the
    ranks' input gradients, as `_CopyToModel`'s all-reduce does."""
    parts = [conv_fn(x, rows, None) for rows in w.chunk(shards, 0)]
    return torch.cat(parts, 1) + b[:, None]


@pytest.mark.parametrize("k", [1, 3])
def test_sharded_gemm_backward_matches_the_whole_layer(k):
    """On a model axis of 2 (the sharded step's setting: hidden 16, 16
    mels), each rank's GEMM backward on its output channels, gathered,
    gives the whole layer's output and gradients."""
    x, w, b, dy = layer(3, 4, 16, 16, 40, k, masked=True)
    p = k // 2
    want = grads(lambda x, w, b: F.conv1d(x, w, b, padding=p), x, w, b, dy)
    got = grads(lambda x, w, b: column_parallel(
        lambda x, rows, bias: Conv1dGemmBackward.apply(x, rows, bias, p),
        x, w, b, 2), x, w, b, dy)
    for g, wnt in zip(got, want):
        assert_near(g, wnt)


def routes(fn):
    conv_ops.reset_route_counts()
    fn()
    return conv_ops.route_counts()


def encoder_routes(device, dtype=None, grad=True):
    """Routes of one MelEncoder and one TextEncoder forward."""
    mel_enc = MelEncoder(8, 6, 10, dtype=dtype, device=device)
    txt_enc = TextEncoder(12, 6, 10, dtype=dtype, device=device)
    mel = torch.randn(2, 9, 8, device=device)
    tokens = torch.randint(0, 12, (2, 5), device=device)
    with torch.set_grad_enabled(grad):
        return routes(lambda: (mel_enc(mel, torch.ones(2, 9, device=device)),
                               txt_enc(tokens)))


@pytest.mark.parametrize("dtype, grad", [(None, True), (None, False),
                                         (torch.bfloat16, True)])
def test_cpu_calls_keep_the_plain_call(dtype, grad):
    """On the CPU every call, float32 training included, is the plain
    F.conv1d call: the route is the card's."""
    assert encoder_routes("cpu", dtype, grad) == {"cudnn": 6}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, grad, want", [
    (None, True, {"gemm_backward": 6}),
    (None, False, {"cudnn": 6}),
    (torch.bfloat16, True, {"cudnn": 6}),
])
def test_card_routes(cuda, dtype, grad, want):
    """float32 training on the card takes the GEMM backward; bfloat16 and
    no_grad keep cuDNN's call."""
    assert encoder_routes(cuda, dtype, grad) == want


@pytest.mark.cuda
def test_card_route_needs_a_graph_and_same_padding(cuda):
    x, w, b, _ = layer(4, 2, 4, 4, 7, 3, device=cuda)
    assert routes(lambda: conv_ops.conv1d(x, w, b, 1)) == {"cudnn": 1}
    w.requires_grad_()
    assert routes(lambda: conv_ops.conv1d(x, w, b, 1)) == {
        "gemm_backward": 1}
    assert routes(lambda: conv_ops.conv1d(x, w, b, 0)) == {"cudnn": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k3", "k1", "k3_masked", "k3_t1",
                                  "k3_no_input_grad", "mel_widths"])
def test_card_gemm_backward_matches_cudnn(cuda, case):
    """On the card (TF32 off), against cuDNN's own backward."""
    B, c_in, c_out, T, k, frames_last, masked, need_x = CASES[case]
    x, w, b, dy = layer(5, B, c_in, c_out, T, k, frames_last=frames_last,
                        masked=masked, device=cuda)
    p = k // 2
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = grads(lambda x, w, b: F.conv1d(x, w, b, padding=p), x, w, b,
                     dy, need_x)
        got = grads(lambda x, w, b: conv_ops.conv1d(x, w, b, (p,)), x, w, b,
                    dy, need_x)
        sharded = grads(lambda x, w, b: column_parallel(
            lambda x, rows, bias: conv_ops.conv1d(x, rows, bias, p),
            x, w, b, 2), x, w, b, dy, need_x)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    assert torch.equal(got[0], want[0])
    for g, s, wnt in zip(got[1:], sharded[1:], want[1:]):
        assert_near(g, wnt)
        assert_near(s, wnt)
