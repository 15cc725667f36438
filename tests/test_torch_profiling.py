"""The port's profiling utilities (`utils/profiling.py`): `benchmark`'s
contract as tests/test_mpc_and_utils.py:445-475 holds the JAX package's,
`annotate` spans in `torch.profiler`'s events, `trace` writing its file, and
the scoped NaN check of `debug_nans`."""

import os

import pytest
import torch

import differentiable_robot_model_tpu_torch as drt
from differentiable_robot_model_tpu_torch.ops.kinematics import fk_world
from differentiable_robot_model_tpu_torch.utils import profiling as P


@pytest.fixture(scope="module")
def fk():
    s = drt.DifferentiableKUKAiiwa(device="cpu").struct
    return lambda q: fk_world(s, q)[1]


def test_benchmark_helper(fk):
    res = P.benchmark(fk, torch.zeros(7), iters=3, warmup=1)
    assert res.mean_s > 0 and res.best_s <= res.mean_s and res.iters == 3
    assert res.throughput(100) > 0 and res.mean_ms == res.mean_s * 1e3


def test_benchmark_windows(fk):
    res = P.benchmark(fk, torch.zeros(7), iters=2, warmup=1, windows=3)
    assert res.mean_s > 0 and res.best_s <= res.mean_s


def test_benchmark_zero_warmup(fk):
    """warmup=0 with either mode (bench.py's calling convention)."""
    for pipelined in (True, False):
        res = P.benchmark(fk, torch.zeros(7), iters=2, warmup=0, windows=2, pipelined=pipelined)
        assert res.mean_s > 0 and res.best_s <= res.mean_s


def test_benchmark_needs_an_iteration(fk):
    with pytest.raises(ValueError, match="iters >= 1"):
        P.benchmark(fk, torch.zeros(7), iters=0)


def test_annotate_span_and_trace_file(tmp_path, fk):
    with P.trace(str(tmp_path)) as prof:
        with P.annotate("solver.phase"):
            fk(torch.zeros(7))
    assert any(e.name == "solver.phase" for e in prof.events())
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    assert "solver.phase" in (tmp_path / files[0]).read_text()


def test_debug_nans():
    assert not P.debug_nans_enabled()
    nan = torch.full((64,), float("nan"))
    with P.debug_nans():
        assert P.debug_nans_enabled()
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(torch.tensor(-1.0))
        del nan
        torch.empty(64)  # likely the freed NaN bits: uninitialised memory is not checked
        torch.empty_like(torch.ones(3))
        with P.debug_nans(False):
            assert not P.debug_nans_enabled()
            assert torch.isnan(torch.log(torch.tensor(-1.0)))
        assert P.debug_nans_enabled()
        with pytest.raises(FloatingPointError):
            torch.tensor([0.0]) / torch.tensor([0.0])
    assert not P.debug_nans_enabled()
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
