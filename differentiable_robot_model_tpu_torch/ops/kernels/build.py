"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each source `csrc/<name>.cu` becomes one shared library with a plain C
interface, compiled for Hopper (`sm_90a`) at first use into
`build/kernels/` of the source checkout (for an installed package, a
per-user cache directory), under a name keyed by a hash of every
file in `csrc/` and the compiler flags. Nothing is compiled or loaded when
a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
_CHECKOUT = Path(__file__).resolve().parents[3]


def _build_dir() -> Path:
    """`build/kernels/` of the source checkout; for an installed package, a
    per-user cache: $TORCH_EXTENSIONS_DIR, else $XDG_CACHE_HOME (~/.cache)."""
    if (_CHECKOUT / "pyproject.toml").is_file():
        return _CHECKOUT / "build" / "kernels"
    base = os.environ.get("TORCH_EXTENSIONS_DIR") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache"), "torch_extensions"
    )
    return Path(base) / "differentiable_robot_model_tpu_torch"


BUILD_DIR = _build_dir()
SOURCES = ("fk", "kin_solve", "dyn_rollout", "dyn_solve", "rnea", "mppi_solve")
# No --use_fast_math: sinf/cosf/sqrtf and division stay IEEE-accurate.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc is not installed: the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names=SOURCES) -> float:
    """Compile every named source not built yet, one nvcc process per source,
    all started together. Returns the wall seconds spent. The compiler's
    report (ptxas registers and spills) is kept beside each library as
    `.log`."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    procs = {}
    try:
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp,
            )
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
            out = library_path(name)
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def load(name: str, configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built if needed; `configure`
    declares its functions' types (and checks its layout) once."""
    if name not in _loaded:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        configure(lib)
        _loaded[name] = lib
    return _loaded[name]


def compiler_report(name: str) -> str:
    """What nvcc and ptxas printed when the library was built."""
    return library_path(name).with_suffix(".log").read_text()


def parse_ptxas(report: str, contains: str = "") -> list[dict]:
    """Per kernel (entry function) in an nvcc report whose name, demangled
    where `c++filt` is installed, contains `contains`: its registers, stack
    frame and spill stores and loads in bytes, from ptxas's lines."""
    entries, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"entry": m.group(1)}
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and "stack" not in cur:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and "registers" not in cur:
            cur["registers"] = int(m.group(1))
    filt = shutil.which("c++filt")
    if filt and entries:
        names = subprocess.run([filt], input="\n".join(e["entry"] for e in entries),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(entries):
            for e, n in zip(entries, names):
                e["entry"] = n.replace("(anonymous namespace)::", "")
    return [e for e in entries if contains in e["entry"]]
