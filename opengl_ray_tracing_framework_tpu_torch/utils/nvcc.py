"""Build a CUDA source of csrc/ into a shared library at first use.

Each kernel is a .cu file with a plain C interface, compiled by nvcc for
sm_90a into build/torch_kernels/ beside the package (a directory git
ignores), named by a hash of every file of csrc/ (the kernels share
headers) and of the flags so an edited source or header is rebuilt, and
loaded with ctypes. A wrapper module registers its source by name at
import, with the function that declares the library's C signatures and the
smallest real launch through its wrapper: `KERNELS` is what the smoke test
builds and what probes/kernel_build.py measures. Nothing is built, loaded
or launched at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LEAD_CYCLES = 1 << 19   # ~0.26 ms at 1.98 GHz: see launch_events
KERNELS: dict = {}   # source name -> (declare(lib), smoke(device) -> launch)
_LOADED: dict = {}


def register(name: str, declare, smoke) -> None:
    """Name csrc/<name>.cu as a kernel of the package. declare(lib) sets the
    C signatures of its loaded library and returns it; smoke(device) puts
    the smallest real inputs on the device and returns a function without
    arguments that launches the kernel on them through its wrapper and
    returns the result."""
    KERNELS[name] = (declare, smoke)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest = digest.hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def compile_source(name: str, out: Path, csrc: Path = CSRC
                   ) -> tuple[float, str]:
    """nvcc <csrc>/<name>.cu (csrc/ of the package unless another copy of
    it is named) -> the shared library `out`, whatever exists there or in
    the cache. Returns (seconds, compiler log)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(Path(csrc) / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def build(name: str) -> tuple[Path, float, str]:
    """Compile csrc/<name>.cu unless its library exists. Returns (path,
    seconds spent compiling, compiler log; 0.0 and "" when cached)."""
    out = library_path(name)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        seconds, log = compile_source(name, Path(tmp))
        os.replace(tmp, out)   # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, seconds, log


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu with its C signatures declared, built
    and loaded on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = KERNELS[name][0](ctypes.CDLL(str(build(name)[0])))
        _LOADED[name] = lib
    return lib


@contextlib.contextmanager
def loaded_from(name: str, path: Path):
    """Inside the block, load(name) gives a fresh load of the library at
    `path` (one compile_source built elsewhere than the cache), so the
    wrapper's next launch is that library's first."""
    saved = _LOADED.get(name)
    _LOADED[name] = KERNELS[name][0](ctypes.CDLL(str(path)))
    try:
        yield _LOADED[name]
    finally:
        if saved is None:
            del _LOADED[name]
        else:
            _LOADED[name] = saved


@contextlib.contextmanager
def launch_events(name: str, log: list):
    """Inside the block, each call of csrc/<name>.cu's `<name>_launch` lies
    between two CUDA events recorded on the current stream just before and
    after it, appended to `log` as (start, end): the kernel's device time.
    Before the first event the stream is kept busy for LEAD_CYCLES of the
    card's clock, longer than the launch call takes on the host, so the
    kernel is queued when the stream passes that event: on an idle stream
    the pair would also time the launch call (on an H100 that more than
    doubled K2's time against the profiler's). Nothing is read back to the host, so the launches
    stay asynchronous; the lead adds device time, so wall times are taken
    outside the block."""
    import torch
    lib, fn = load(name), f"{name}_launch"
    launch = getattr(lib, fn)

    def timed(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(LEAD_CYCLES)
        start.record()
        rc = launch(*args)
        end.record()
        log.append((start, end))
        return rc

    setattr(lib, fn, timed)
    try:
        yield log
    finally:
        setattr(lib, fn, launch)
