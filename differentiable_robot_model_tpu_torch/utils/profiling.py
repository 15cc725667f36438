"""Profiling, benchmarking and numerical-debug utilities.

PyTorch counterparts of the JAX package's `utils/profiling.py`: timing
that waits for the card (`torch.cuda.synchronize` of the outputs' devices
where JAX blocks until ready), a `torch.profiler` trace written to a file,
named spans for solver phases, and a scoped NaN check.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@dataclass
class BenchResult:
    mean_s: float
    best_s: float
    iters: int

    @property
    def mean_ms(self) -> float:
        return self.mean_s * 1e3

    def throughput(self, items: int) -> float:
        return items / self.mean_s


def _block(out) -> None:
    """Wait until the work behind every CUDA tensor in `out` is done."""
    for dev in {x.device for x in tree_leaves(out)
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def benchmark(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 2,
    pipelined: bool = True,
    windows: int = 1,
    **kwargs,
) -> BenchResult:
    """Wall time of `fn(*args, **kwargs)` that waits for the card.

    pipelined=True (default) queues all `iters` calls and waits once: the
    throughput of back-to-back calls. pipelined=False waits after every
    call: the latency of one call. `windows` repeats the pipelined
    measurement; `.best_s` is the best window's, `.mean_s` the mean over
    all windows. `iters < 1` raises.
    """
    if iters < 1:
        raise ValueError(f"benchmark() requires iters >= 1, got {iters}")
    if warmup:
        for _ in range(warmup):
            out = fn(*args, **kwargs)
        _block(out)
    if pipelined:
        per_window = []
        for _ in range(max(1, windows)):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*args, **kwargs)
            _block(out)
            per_window.append((time.perf_counter() - t0) / iters)
        return BenchResult(sum(per_window) / len(per_window), min(per_window), iters)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _block(out)
        times.append(time.perf_counter() - t0)
    return BenchResult(sum(times) / len(times), min(times), iters)


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a `torch.profiler` trace of the block (host and, where CUDA
    exists, the card) and write it to `log_dir` as a Chrome trace file
    (`trace_<pid>_<ns>.json`, readable by Perfetto or chrome://tracing).
    Yields the profiler, whose `key_averages()` can be read after."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named span for a solver phase: it shows up in the profiler's
    events (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)


# Ops whose outputs are uninitialised memory: a NaN there is no fault.
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                  "resize_", "resize_as_"}
_debug_nans = False


def debug_nans_enabled() -> bool:
    """Whether `debug_nans` checks ops now."""
    return _debug_nans


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _debug_nans and func.overloadpacket.__name__ not in _UNINITIALISED:
            for x in tree_leaves(out):
                if (isinstance(x, torch.Tensor) and (x.is_floating_point() or x.is_complex())
                        and bool(torch.isnan(x).any())):
                    raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN check, the port's `jax_debug_nans`: while it is on, an op
    whose floating-point output holds a NaN raises `FloatingPointError`
    naming the op. `debug_nans(False)` turns the check off inside an outer
    `debug_nans()`; on exit the previous state returns.

    It checks every op that reaches PyTorch's dispatcher (a host sync per
    op on the card) except those that make uninitialised memory
    (`torch.empty` and its kin, whose bits may read as NaN). The port's
    CUDA kernels launch through ctypes, which the dispatcher does not see:
    their outputs are not checked at the launch; a NaN a kernel writes is
    caught at the first later op whose output carries it.
    """
    global _debug_nans
    prev = _debug_nans
    _debug_nans = enable
    try:
        with _NanCheck() if enable and not prev else contextlib.nullcontext():
            yield
    finally:
        _debug_nans = prev
