"""Build, load, bind, launch and count the port's hand-written CUDA kernels.

Each kernel source in ``pde_opt_tpu_torch/csrc/`` exposes a plain C
interface; the ``*.cuh`` headers there hold device code they share.
:func:`load_library` compiles a source at first use with ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/`` at the repository root and loads
it with :mod:`ctypes`; the library's file name carries a hash of the source,
the headers and the flags, so an edited source is rebuilt.  Nothing is downloaded and
only sources of this package are compiled.  Importing this module compiles
nothing, so CPU-only machines can import every module of the port.

The rules every kernel's call follows live here.  A kernel's module declares
its library's C entries with :func:`bind` (its ``_bind_library(lib, name)``)
and spells each launching entry ``<entry>`` once, as ``_<entry>(lib, ...,
stream)``: that function allocates the outputs and the scratch
(:func:`alloc_scratch`), lists the arguments in order and raises on a
nonzero return code (:func:`check`), for the card's library
(:func:`library`) and the tests' CPU stub build alike.  The ``*_cuda``
wrapper checks its tensors (:func:`check_cuda`), calls it inside
:class:`device_stream` and counts the launch with :func:`count_launch`, and
nowhere else, so a run can show that its main path went through the kernels
(:func:`launch_counts`).  Each module declares its counters with
:func:`register_launches`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

__all__ = [
    "NVCC_FLAGS",
    "load_library",
    "load_libraries",
    "library_path",
    "build_log",
    "bind",
    "library",
    "check",
    "SCRATCH_OUT",
    "scratch_size",
    "alloc_scratch",
    "check_cuda",
    "data_ptr",
    "device_stream",
    "register_launches",
    "count_launch",
    "launch_counts",
    "reset_launch_counts",
]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_LOGS: Dict[str, str] = {}
_LOCK = threading.Lock()
# Launches per counter; each module registers its own (register_launches).
_LAUNCHES: Dict[str, int] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if Path("/usr/local/cuda/bin/nvcc").exists() else None
    )
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are built from source at first use"
        )
    return found


def load_libraries(*names: str) -> List[ctypes.CDLL]:
    """Build (if needed) and load ``csrc/<name>.cu`` for each name; raise if
    a build fails.  Missing libraries are compiled in parallel, one ``nvcc``
    per source, all started together."""
    with _LOCK:
        builds = []
        for name in names:
            if name in _LIBS:
                continue
            src = CSRC / f"{name}.cu"
            # The shared headers are part of every kernel's source.
            headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
            digest = hashlib.sha256(
                src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
            ).hexdigest()[:16]
            lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
            if lib_path.exists():
                _LIBS[name] = ctypes.CDLL(str(lib_path))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            builds.append((name, src, tmp, lib_path, proc))
        failed = []
        for name, src, tmp, lib_path, proc in builds:
            _, err = proc.communicate()
            _BUILD_LOGS[name] = err
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed to build {src.name}:\n{err}")
                continue
            os.replace(tmp, lib_path)      # atomic: concurrent builds agree
            _LIBS[name] = ctypes.CDLL(str(lib_path))
        if failed:
            raise RuntimeError("\n".join(failed))
        return [_LIBS[name] for name in names]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raise if the build fails."""
    return load_libraries(name)[0]


def library_path(name: str) -> str:
    """The file of the loaded library built from ``csrc/<name>.cu`` (for
    ``cuobjdump``); raises ``KeyError`` if it is not loaded."""
    return _LIBS[name]._name


def build_log(name: str) -> str:
    """What ``nvcc`` (with ``ptxas -v``: registers, shared memory, spills)
    printed when this process built ``csrc/<name>.cu``; empty if it loaded
    a library built before."""
    return _BUILD_LOGS.get(name, "")


def bind(lib: ctypes.CDLL, entries: Mapping[str, Sequence]) -> ctypes.CDLL:
    """Declare on ``lib`` each of ``entries`` (C function -> argument
    types; every one returns an ``int``) and ``kernel_error_string``, which
    every kernel library exports (``csrc/kernel_error.cuh``).  ``lib`` is a
    library built for the card, or for the CPU by the tests' stub build."""
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def library(name: str, bind_library: Callable[[ctypes.CDLL, str], ctypes.CDLL]) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built and loaded (:func:`load_library`) and its C
    interface declared by ``bind_library(lib, name)``, once a process."""
    return bind_library(load_library(name), name)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise ``RuntimeError`` naming ``what`` and CUDA's message where a C
    entry of ``lib`` returned the nonzero code ``rc``."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: {lib.kernel_error_string(rc).decode()}")


# The two out-pointers a scratch query ends with: slots, floats a slot.
SCRATCH_OUT = (ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong))


@functools.lru_cache(maxsize=None)
def scratch_size(lib: ctypes.CDLL, query: str, device_index: Optional[int],
                 *args: int) -> Tuple[int, int]:
    """``(slots, floats)``: the scratch a launch needs on one device (None:
    the CPU of a stub build), one slot of ``floats`` f32 for each block
    resident at once, as ``lib``'s ``query`` gives it for ``args``; ``(0,
    0)`` where the kernel takes none.  Asked once per library, device and
    arguments."""
    n, floats = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(-1 if device_index is None else device_index):
        rc = getattr(lib, query)(*args, ctypes.byref(n), ctypes.byref(floats))
    check(lib, rc, query)
    return n.value, floats.value


def alloc_scratch(lib: ctypes.CDLL, query: str, device: torch.device, B: int,
                  *args: int) -> Tuple[Optional[torch.Tensor], int]:
    """``(scratch, slots)`` for a launch of ``B`` envs: ``min(B, slots)``
    slots as :func:`scratch_size` sizes them, allocated with ``torch.empty``
    (``(None, 0)`` where the kernel takes none).  Raises ``RuntimeError``
    naming the size where the device cannot hold it (K3 at 256² keeps n + 5
    planes of 256 KB a slot: 14 MB at 50 substeps)."""
    slots, floats = scratch_size(lib, query, device.index, *args)
    if floats == 0:
        return None, 0
    slots = min(B, slots)
    try:
        return torch.empty((slots * floats,), dtype=torch.float32, device=device), slots
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            f"{query}{tuple(args)}: {slots} scratch slots of {floats * 4 / 2**20:.1f} MiB do "
            f"not fit on {device}; run fewer substeps a call") from e


def check_cuda(name: str, t: torch.Tensor, shape, dtype: torch.dtype,
               device: torch.device) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous, 16-byte aligned
    CUDA tensor of ``shape`` and ``dtype`` on ``device``."""
    if t.device.type != "cuda":
        raise ValueError(
            f"the CUDA macro needs CUDA tensors; {name} is on {t.device}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(
            f"{name} must be {dtype} of shape {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def data_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """``t``'s address as a C entry takes it; null for None."""
    return None if t is None else t.data_ptr()


class device_stream(torch.cuda.device):
    """``with device_stream(device) as stream:`` makes ``device`` current,
    as :class:`torch.cuda.device` does, and gives the handle of its current
    stream, on which a kernel's ``_<entry>`` launches."""

    def __enter__(self):
        super().__enter__()
        return torch.cuda.current_stream(self.idx).cuda_stream


def register_launches(*names: str) -> None:
    """Declare the launch counters ``names`` (each module its own, at
    import); :func:`count_launch` raises on any other name."""
    for name in names:
        _LAUNCHES.setdefault(name, 0)


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper only)."""
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
