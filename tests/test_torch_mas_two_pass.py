"""The two-pass MAS route of aligner_tpu_torch against the JAX package:
`mas_bits`, `mas_backtrack` and `mas_path(fuse=False, ...)` on the CPU
(plain versions) against mas_pallas_bits_nat, mas_pallas_backtrack_nat
(stage and cmp), mas_pallas_backtrack_nat_split, mas_pallas_bits_nat_multi
and mas_pallas_backtrack_nat_multi in interpret mode, on the inputs of
tests/test_mas_pallas.py (ragged, one invalid item, an odd walk chunk).

Tolerance: exact equality. Paths are compared on every cell; decision
bits on the cells the walk can read, since the JAX forward takes no
lengths and fills the cells the port leaves 0. The JAX bits are int8
[T_y_pad, B, T_x], the port's uint8 [B, T_y, T_x]; `to_port_bits` and
`to_jax_bits` convert, so that either walk can be fed either bits.
"""
import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from aligner_tpu.ops.mas_pallas import (mas_pallas_backtrack_nat,
                                        mas_pallas_backtrack_nat_multi,
                                        mas_pallas_backtrack_nat_split,
                                        mas_pallas_bits_nat,
                                        mas_pallas_bits_nat_multi)
from aligner_tpu_torch.ops import mas_backtrack, mas_bits
from aligner_tpu_torch.ops.mas_kernel import (mas_expand, mas_expand_plain,
                                              mas_path, mas_plain,
                                              mas_walk_idx,
                                              mas_walk_idx_plain)
from aligner_tpu_torch.ops.mas_reference import mas_single

T_X, T_Y = 8, 40
CASES = [(63, 4), (64, 8)]                # seed, B
# route name -> (mas_path / mas_backtrack options, chains of the forward)
ROUTES = {"cmp": {}, "stage": {"form": "stage"}, "split": {"form": "split"},
          "chains2": {"chains": 2}, "chains4": {"chains": 4}}


@functools.lru_cache(maxsize=None)
def case(seed, B):
    """The batch of tests/test_mas_pallas.py: ragged, item 1 invalid
    (t_x = T_x > t_y = 2)."""
    rng = np.random.default_rng(seed)
    value = (rng.standard_normal((B, T_X, T_Y)) * 3).astype(np.float32)
    t_x = rng.integers(1, T_X + 1, B).astype(np.int32)
    t_y = np.maximum(t_x, rng.integers(T_Y // 2, T_Y + 1, B)) \
        .astype(np.int32)
    t_x[1], t_y[1] = T_X, 2
    return value, t_x, t_y


def tensors(seed, B):
    return tuple(torch.from_numpy(a) for a in case(seed, B))


def to_port_bits(jax_bits, T_y):
    """int8 [T_y_pad, B, T_x] -> uint8 [B, T_y, T_x]."""
    return np.ascontiguousarray(
        np.asarray(jax_bits)[:T_y].transpose(1, 0, 2)).astype(np.uint8)


def to_jax_bits(port_bits, T_y_pad):
    """uint8 [B, T_y, T_x] -> int8 [T_y_pad, B, T_x], padded frames 0."""
    bits = np.asarray(port_bits).transpose(1, 0, 2).astype(np.int8)
    pad = T_y_pad - bits.shape[0]
    return jnp.asarray(np.pad(bits, ((0, pad), (0, 0), (0, 0))))


def readable(t_x, t_y, T_x, T_y):
    """[B, T_y, T_x] bool: the cells the walk of a valid item can read."""
    xs = np.arange(T_x)[None, None, :]
    ys = np.arange(T_y)[None, :, None]
    tx, ty = t_x[:, None, None], t_y[:, None, None]
    valid = (tx >= 1) & (tx <= ty) & (tx <= T_x) & (ty <= T_y)
    return valid & (xs < tx) & (ys < ty) & (xs <= ys) & (xs >= tx - (ty - ys))


def oracle(value, t_x, t_y):
    out = np.zeros(value.shape, np.int32)
    for i in range(value.shape[0]):
        if 1 <= t_x[i] <= t_y[i]:
            out[i] = mas_single(value[i].copy(), int(t_x[i]), int(t_y[i]))
    return out


@functools.lru_cache(maxsize=None)
def jax_bits(seed, B, chains=1):
    value, _, _ = case(seed, B)
    if chains == 1:
        return mas_pallas_bits_nat(jnp.asarray(value), interpret=True,
                                   _chunk=8)
    return mas_pallas_bits_nat_multi(jnp.asarray(value), chains=chains,
                                     interpret=True, _chunk=8)


@functools.lru_cache(maxsize=None)
def jax_path(seed, B, route, chunk):
    """The JAX walk of `route` over the single-chain JAX bits."""
    _, t_x, t_y = case(seed, B)
    args = (jax_bits(seed, B), jnp.asarray(t_x), jnp.asarray(t_y))
    if route in ("cmp", "stage"):
        path = mas_pallas_backtrack_nat(*args, interpret=True, _chunk=chunk,
                                        form=route)
    elif route == "split":
        path = mas_pallas_backtrack_nat_split(*args, interpret=True,
                                              _chunk=chunk)
    else:
        path = mas_pallas_backtrack_nat_multi(
            *args, chains=ROUTES[route]["chains"], interpret=True,
            _chunk=chunk)
    return np.asarray(path)[:, :, :T_Y]


@pytest.mark.parametrize("chains", [1, 2, 4])
@pytest.mark.parametrize("seed,B", CASES)
def test_bits_match_jax_on_readable_cells(seed, B, chains):
    value, t_x, t_y = case(seed, B)
    got = mas_bits(*tensors(seed, B), chains=chains)
    assert got.dtype == torch.uint8 and got.shape == (B, T_Y, T_X)
    want = to_port_bits(jax_bits(seed, B, chains), T_Y)
    cells = readable(t_x, t_y, T_X, T_Y)
    assert cells[0].any() and not cells[1].any()
    np.testing.assert_array_equal(got.numpy()[cells], want[cells])
    # every other cell is defined too: 0, for any number of chains
    assert not got.numpy()[~cells].any()


@pytest.mark.parametrize("chunk", [8, 5])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("seed,B", CASES)
def test_backtrack_matches_jax(seed, B, route, chunk):
    """Each walk of the port over the port's bits gives the path of its
    JAX counterpart over the JAX bits; chunk 5 is the JAX kernels' odd
    walk prologue."""
    v, tx, ty = tensors(seed, B)
    got = mas_backtrack(mas_bits(v, tx, ty), tx, ty, **ROUTES[route])
    want = jax_path(seed, B, route, chunk)
    assert got.dtype == torch.float32 and not want[1].any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("seed,B", CASES)
def test_two_pass_path_matches_jax_fused_and_oracle(seed, B, route):
    value, t_x, t_y = case(seed, B)
    v, tx, ty = tensors(seed, B)
    got = mas_path(v, tx, ty, fuse=False, **ROUTES[route])
    np.testing.assert_array_equal(got.numpy(), jax_path(seed, B, route, 8))
    torch.testing.assert_close(got, mas_path(v, tx, ty), rtol=0, atol=0)
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  oracle(value, t_x, t_y))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("seed,B", CASES)
def test_jax_bits_through_the_ports_walk(seed, B, route):
    _, tx, ty = tensors(seed, B)
    bits = torch.from_numpy(to_port_bits(jax_bits(seed, B), T_Y))
    got = mas_backtrack(bits, tx, ty, **ROUTES[route])
    np.testing.assert_array_equal(got.numpy(), jax_path(seed, B, "cmp", 8))


@pytest.mark.parametrize("chains", [1, 2, 4])
@pytest.mark.parametrize("seed,B", CASES)
def test_the_ports_bits_through_the_jax_walk(seed, B, chains):
    _, t_x, t_y = case(seed, B)
    theirs = jax_bits(seed, B)
    ours = to_jax_bits(mas_bits(*tensors(seed, B), chains=chains),
                       theirs.shape[0])
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    got = mas_pallas_backtrack_nat(ours, jnp.asarray(t_x), jnp.asarray(t_y),
                                   interpret=True, _chunk=8)
    np.testing.assert_array_equal(np.asarray(got)[:, :, :T_Y],
                                  jax_path(seed, B, "cmp", 8))


@pytest.mark.parametrize("seed,B", CASES)
def test_walk_indices_match_the_jax_split_walk(seed, B):
    """`mas_pallas_backtrack_nat_split` keeps its index row to itself;
    its path gives it back as argmax + 1 on the frames that emit."""
    _, tx, ty = tensors(seed, B)
    path = jax_path(seed, B, "split", 8)
    want = (path.argmax(1) + 1) * (path.sum(1) > 0)
    bits = mas_bits(*tensors(seed, B))
    idx = mas_walk_idx_plain(bits, tx, ty)
    assert idx.dtype == torch.int32 and idx.shape == (B, T_Y)
    np.testing.assert_array_equal(idx.numpy(), want)
    assert not idx[1].any()
    assert torch.equal(mas_walk_idx(bits, tx, ty), idx)
    np.testing.assert_array_equal(mas_expand_plain(idx, T_X).numpy(), path)
    assert torch.equal(mas_expand(idx, T_X, frame_major=True),
                       mas_expand(idx, T_X).transpose(1, 2))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("seed,B", CASES)
def test_frame_major_on_every_route(seed, B, route):
    v, tx, ty = tensors(seed, B)
    got = mas_path(v, tx, ty, fuse=False, frame_major=True, **ROUTES[route])
    assert got.shape == (B, T_Y, T_X) and got.is_contiguous()
    assert torch.equal(got, mas_plain(v, tx, ty).transpose(1, 2))
    # a transposed view of a frame-major lattice is read in place
    view = v.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(mas_path(view, tx, ty, fuse=False, **ROUTES[route]),
                       got.transpose(1, 2))


@st.composite
def tie_batches(draw):
    """A ragged batch of small integers (equal DP sums are common, as in
    test_tie_stress_quantized_lattice) with contract edges mixed in."""
    B = draw(st.sampled_from([4, 8]))
    T_x = draw(st.integers(1, 12))
    T_y = draw(st.integers(T_x, 40))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    value = rng.integers(-2, 3, (B, T_x, T_y)).astype(np.float32)
    t_x = rng.integers(0, T_x + 2, B).astype(np.int32)      # 0 and T_x + 1
    t_y = rng.integers(1, T_y + 1, B).astype(np.int32)      # t_x > t_y too
    t_x[0], t_y[0] = T_x, T_y
    return value, t_x, t_y


@pytest.mark.parametrize("route", list(ROUTES))
@settings(max_examples=25, deadline=None)
@given(batch=tie_batches())
def test_routes_equal_plain_and_oracle_under_ties(route, batch):
    value, t_x, t_y = batch
    v, tx, ty = (torch.from_numpy(a) for a in batch)
    got = mas_path(v, tx, ty, fuse=False, **ROUTES[route])
    assert torch.equal(got, mas_plain(v, tx, ty))
    inside = np.where(t_x <= value.shape[1], t_x, 0)   # oversize: zero path
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  oracle(value, inside, t_y))


@pytest.mark.parametrize("call,kwargs,match", [
    ("mas_backtrack", {"form": "packed"}, "unknown backtrack form"),
    ("mas_path", {"form": "packed"}, "unknown backtrack form"),
    ("mas_path", {"fuse": False, "form": "packed"},
     "unknown backtrack form"),
    ("mas_bits", {"chains": 4}, "must divide B"),
    ("mas_backtrack", {"chains": 4}, "must divide B"),
    ("mas_path", {"fuse": False, "chains": 4}, "must divide B"),
    ("mas_bits", {"chains": 0}, "chains must be"),
    ("mas_bits", {"chains": 3}, "chains must be"),
    ("mas_backtrack", {"chains": 8}, "chains must be"),
    ("mas_path", {"fuse": False, "chains": 2.0}, "chains must be"),
    ("mas_backtrack", {"form": "stage", "chains": 2}, "compare form only"),
    ("mas_backtrack", {"form": "split", "chains": 4}, "compare form only"),
    ("mas_path", {"fuse": False, "form": "stage", "chains": 2},
     "compare form only"),
    ("mas_path", {"form": "stage"}, "pass fuse=False"),
    ("mas_path", {"form": "split"}, "pass fuse=False"),
    ("mas_path", {"chains": 2}, "pass fuse=False"),
    ("mas_path", {"fuse": True, "chains": 4}, "pass fuse=False"),
])
def test_bad_options_raise(call, kwargs, match):
    v, tx, ty = tensors(64, 6 if match == "must divide B" else 8)
    with pytest.raises(ValueError, match=match):
        if call == "mas_backtrack":
            mas_backtrack(mas_bits(v, tx, ty), tx, ty, **kwargs)
        else:
            {"mas_bits": mas_bits, "mas_path": mas_path}[call](v, tx, ty,
                                                               **kwargs)


@pytest.mark.parametrize("route", list(ROUTES))
def test_bits_from_elsewhere_keep_the_walk_in_the_lattice(route):
    """Any non-zero byte is a set bit, and a set bit in row 0 does not
    take the walk below token 0."""
    v, tx, ty = tensors(64, 8)
    bits = mas_bits(v, tx, ty)
    foreign = bits * 3
    foreign[:, :, 0] = 1
    assert torch.equal(mas_backtrack(foreign, tx, ty, **ROUTES[route]),
                       mas_backtrack(bits, tx, ty, **ROUTES[route]))
    assert torch.equal(mas_walk_idx_plain(foreign, tx, ty),
                       mas_walk_idx_plain(bits, tx, ty))


@pytest.mark.parametrize("what", ["dtype", "rank", "strides", "lengths"])
def test_backtrack_rejects_bad_bits(what):
    v, tx, ty = tensors(63, 4)
    bits = mas_bits(v, tx, ty)
    with pytest.raises((TypeError, ValueError)):
        if what == "dtype":
            mas_backtrack(bits.bool(), tx, ty)
        elif what == "rank":
            mas_backtrack(bits[0], tx, ty)
        elif what == "strides":
            mas_backtrack(bits.transpose(1, 2), tx, ty)
        else:
            mas_backtrack(bits, tx[:2], ty)
