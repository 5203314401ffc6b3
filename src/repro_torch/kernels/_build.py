"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (``build/repro_torch/lib<name>.so`` at the repo
root, a git-ignored directory), loaded through ``ctypes``. Nothing is
built when a module is imported: :meth:`CudaKernel.lib` builds at the first
launch, and :func:`build_all` starts one ``nvcc`` per source in parallel
(what ``chip_smoke.py`` does up front). A library is rebuilt when its
source is newer.

A launch recorded into a CUDA graph runs at each replay, not at capture:
:func:`launch_snapshot`, :func:`launches_since` and :func:`add_launches`
let the graph's owner (``core.engine.TickProgram``) take the counts a
capture recorded back out and add them again at every replay.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
_KERNELS: List["CudaKernel"] = []  # every kernel, for launch accounting
# objects a graph being captured reads by address; its owner keeps them
_KEEP_ALIVE: Optional[list] = None


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


class CudaKernel:
    """One ``.cu`` source, its shared library and its launch count.

    ``entries`` maps each C entry point to its argument signature, one
    letter per argument: ``p`` for a pointer or the stream, ``i`` for an
    int, ``f`` for a float. Every entry returns ``cudaGetLastError()``
    after its launch.
    ``launches`` is incremented by the wrapper at each kernel launch and
    nowhere else (a launch captured into a CUDA graph counts at each
    replay instead, see the module docstring), so a run can show that it
    went through the kernel;
    ``entry_launches`` counts the launches of each entry point (a source
    with several kernels has one entry per kernel and dtype).
    """

    def __init__(self, name: str, entries: Dict[str, str]):
        self.name = name
        self.entries = entries
        self._lib = None
        self.reset()
        _KERNELS.append(self)

    def reset(self) -> None:
        """Set every launch count to 0."""
        self.launches = 0
        self.entry_launches = dict.fromkeys(self.entries, 0)

    @property
    def source(self) -> Path:
        return CSRC_DIR / f"{self.name}.cu"

    @property
    def library(self) -> Path:
        return BUILD_DIR / f"lib{self.name}.so"

    @property
    def log(self) -> Path:
        return BUILD_DIR / f"{self.name}.log"

    def stale(self) -> bool:
        return (not self.library.exists()
                or self.library.stat().st_mtime < self.source.stat().st_mtime)

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.library))
            for fn, sig in self.entries.items():
                f = getattr(lib, fn)
                f.argtypes = [_CTYPES[c] for c in sig]
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, entry: str, *args) -> None:
        """Launch through ``entry`` and raise if the launch was refused."""
        err = getattr(self.lib(), entry)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}.{entry}: CUDA error {err} at "
                               "launch")
        self.launches += 1
        self.entry_launches[entry] += 1


LaunchCounts = List[Tuple[CudaKernel, int, Dict[str, int]]]


def launch_snapshot() -> LaunchCounts:
    """Every kernel's launch counts now."""
    return [(k, k.launches, dict(k.entry_launches)) for k in _KERNELS]


def launches_since(snapshot: LaunchCounts) -> LaunchCounts:
    """The launches each kernel counted after ``snapshot``."""
    return [(k, k.launches - n, {e: k.entry_launches[e] - m
                                 for e, m in per.items()})
            for k, n, per in snapshot if k.launches != n]


def add_launches(delta: LaunchCounts, sign: int = 1) -> None:
    """Add (``sign`` -1: take back) the launches of ``delta``."""
    for k, n, per in delta:
        k.launches += sign * n
        for e, m in per.items():
            k.entry_launches[e] += sign * m


def keep_alive(obj) -> None:
    """Hold ``obj`` for the life of the CUDA graph being captured, if one
    is: the graph reads its tensors by address, and a cache may drop
    them."""
    if _KEEP_ALIVE is not None:
        _KEEP_ALIVE.append(obj)


@contextlib.contextmanager
def kept_alive() -> Iterator[list]:
    """Collect what :func:`keep_alive` is handed inside the block (around
    a capture) into the list it yields."""
    global _KEEP_ALIVE
    prev, _KEEP_ALIVE = _KEEP_ALIVE, []
    try:
        yield _KEEP_ALIVE
    finally:
        _KEEP_ALIVE = prev


def build_all(kernels: Iterable[CudaKernel]) -> List[CudaKernel]:
    """Compile every stale kernel, one ``nvcc`` process per source, all
    started together; ``-Xptxas=-v`` output goes to ``<name>.log``.
    Returns the kernels that were rebuilt."""
    todo = [k for k in kernels if k.stale()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for k in todo:
        tmp = k.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        log = open(k.log, "w")
        procs.append((k, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for k, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{k.name} (rc {rc}):\n{k.log.read_text()}")
        else:
            os.replace(tmp, k.library)  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return todo
