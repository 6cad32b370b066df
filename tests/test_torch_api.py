"""Names and keywords of the port's public API against the JAX package's:
`aligner_tpu_torch.utils` exports the eight names of `aligner_tpu.utils`,
the frame-major hard paths take `implementation="auto"` (and refuse the
JAX package's own routes) and `device_op_durations` takes `trace_dir`."""
import inspect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

import aligner_tpu.utils as jax_utils
from aligner_tpu.ops import mas as jax_mas
from aligner_tpu.ops import skip_dp as jax_skip_dp
from aligner_tpu.utils import profiling as jax_profiling
import aligner_tpu_torch.utils as utils
from aligner_tpu_torch.ops import mas, skip_dp
from aligner_tpu_torch.utils import profiling


def test_utils_exports_the_jax_names():
    assert utils.__all__ == jax_utils.__all__
    for name in utils.__all__:
        assert callable(getattr(utils, name)), name


def lattice(seed, B, T_s, T_y):
    rng = np.random.default_rng(seed)
    logp = (rng.standard_normal((B, T_y, T_s)) * 3).astype(np.float32)
    t_x = rng.integers(1, 6, B).astype(np.int32)
    t_y = np.maximum(2 * t_x + 1, rng.integers(4, T_y + 1, B)) \
        .astype(np.int32)
    return logp, t_x, t_y


@pytest.mark.parametrize("skip", [False, True], ids=["mas", "skip"])
def test_frame_major_paths_take_implementation_auto(skip):
    """The call written for the JAX package runs in the port and gives the
    JAX package's path; the JAX routes' names raise ValueError."""
    T_x = 5
    logp, t_x, t_y = lattice(3, 4, 2 * T_x + 1 if skip else T_x, 24)
    port = skip_dp.mas_skip_path_frame_major if skip \
        else mas.mas_path_frame_major
    ref = jax_skip_dp.mas_skip_path_frame_major if skip \
        else jax_mas.mas_path_frame_major
    got = port(torch.from_numpy(logp), torch.from_numpy(t_x),
               torch.from_numpy(t_y), implementation="auto")
    want = ref(jnp.asarray(logp), jnp.asarray(t_x), jnp.asarray(t_y),
               implementation="auto")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in ("lax", "pallas", "cpp"):
        with pytest.raises(ValueError, match="routes of the JAX package"):
            port(torch.from_numpy(logp), torch.from_numpy(t_x),
                 torch.from_numpy(t_y), implementation=name)


def test_device_op_durations_takes_trace_dir(tmp_path):
    assert "trace_dir" in inspect.signature(
        jax_profiling.device_op_durations).parameters
    a = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.mm(a, a)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    by_dir = profiling.device_op_durations(trace_dir=str(tmp_path))
    assert len(by_dir["aten::mm"]) == 1
    assert profiling.device_op_durations(str(tmp_path)) == by_dir
