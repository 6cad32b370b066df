"""The port's C++ MAS oracle (`aligner_tpu_torch.native`, a copy of
aligner_tpu/native) and `maximum_path(..., implementation="cpp")`:
bit-identical to the NumPy oracle, to the port's plain route and to the
JAX package's build of the same source, with 1 and 4 threads, without
touching the caller's lattice, and raising on lengths outside
1 <= t_x <= t_y."""
import numpy as np
import pytest
import torch

from aligner_tpu.native import maximum_path_cpp as jax_maximum_path_cpp
from aligner_tpu_torch import OTAAligner, OTAConfig
from aligner_tpu_torch.native import build, maximum_path_cpp
from aligner_tpu_torch.ops.mas import maximum_path
from aligner_tpu_torch.ops.mas_reference import maximum_path_numpy
from aligner_tpu_torch.utils.masks import lattice_mask


def make_batch(seed, B=8, T_x=24, T_y=48, ties=False):
    """A ragged batch with the item shapes t_x = 1 and t_x = t_y among
    them; `ties` makes the lattice integer-valued, so that many moves
    tie."""
    rng = np.random.default_rng(seed)
    if ties:
        value = rng.integers(-2, 3, (B, T_x, T_y)).astype(np.float32)
    else:
        value = (rng.standard_normal((B, T_x, T_y)) * 3).astype(np.float32)
    t_xs = rng.integers(1, T_x + 1, B)
    t_ys = np.maximum(t_xs, rng.integers(1, T_y + 1, B))
    t_xs[0], t_ys[0] = 1, T_y
    t_xs[1] = t_ys[1] = T_x
    mask = lattice_mask(torch.from_numpy(t_xs), torch.from_numpy(t_ys),
                        T_x, T_y).numpy()
    return value, mask


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True)])
def test_cpp_matches_the_oracles(seed, ties, n_threads):
    value, mask = make_batch(seed, ties=ties)
    got = maximum_path_cpp(value, mask, n_threads=n_threads)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, maximum_path_numpy(value, mask))
    np.testing.assert_array_equal(
        got, jax_maximum_path_cpp(value, mask, n_threads=n_threads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_implementation_cpp_matches_auto(dtype):
    """The host route and the device route (here the plain version) give
    one path, in `value`'s dtype and on its device."""
    value, mask = make_batch(3, ties=True)
    v = torch.from_numpy(value).to(dtype)
    m = torch.from_numpy(mask)
    got = maximum_path(v, m, implementation="cpp")
    assert got.dtype == dtype and got.device == v.device
    torch.testing.assert_close(got, maximum_path(v, m), rtol=0, atol=0)
    np.testing.assert_array_equal(
        got.to(torch.int32).numpy(),
        maximum_path_numpy(v.float().numpy(), mask))


def test_cpp_takes_tensors_and_leaves_them_alone():
    value, mask = make_batch(4)
    v, m = torch.from_numpy(value.copy()), torch.from_numpy(mask)
    before = v.clone()
    got = maximum_path_cpp(v, m, n_threads=4)
    assert torch.equal(v, before)
    np.testing.assert_array_equal(got, maximum_path_numpy(value, mask))
    arr = value.copy()
    maximum_path_cpp(arr, mask)
    np.testing.assert_array_equal(arr, value)


@pytest.mark.parametrize("t_x,t_y", [(6, 4), (0, 4)],
                         ids=["t_x_over_t_y", "t_x_zero"])
def test_cpp_rejects_invalid_lengths(t_x, t_y):
    mask = lattice_mask(torch.tensor([3, t_x]), torch.tensor([5, t_y]), 6, 8)
    value = torch.ones(mask.shape)
    with pytest.raises(ValueError, match="invalid lengths"):
        maximum_path_cpp(value, mask)
    with pytest.raises(ValueError, match="invalid lengths"):
        maximum_path(value, mask, implementation="cpp")
    # the device route gives such an item an all-zero path instead
    assert float(maximum_path(value, mask)[1].sum()) == 0.0


def test_cpp_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="one shape"):
        maximum_path_cpp(np.zeros((2, 3, 4), np.float32),
                         np.ones((2, 3, 5), np.float32))


@pytest.mark.parametrize("name", ["lax", "pallas", "cuda"])
def test_unknown_implementation_raises(name):
    value, mask = make_batch(5, B=2)
    with pytest.raises(ValueError, match="routes by device"):
        maximum_path(torch.from_numpy(value), torch.from_numpy(mask),
                     implementation=name)


@pytest.mark.parametrize("name", ["cpp", "lax", "pallas"])
def test_ota_refuses_other_mas_implementations(name):
    """The train step's hard path stays on the device (H1 on the card);
    the host oracle would copy every step's lattice to the host."""
    with pytest.raises(ValueError, match="routes MAS by device"):
        OTAAligner(OTAConfig(vocab_size=8, dim=8, hidden=8,
                             mas_implementation=name))


def test_cache_directory_is_overridable(tmp_path, monkeypatch):
    monkeypatch.setenv("ALIGNER_TPU_TORCH_NATIVE_CACHE", str(tmp_path))
    monkeypatch.setattr(build, "_LIB", None)
    value, mask = make_batch(6, B=3)
    np.testing.assert_array_equal(maximum_path_cpp(value, mask),
                                  maximum_path_numpy(value, mask))
    assert [p.name for p in tmp_path.glob("mas_cpu_*.so")]
