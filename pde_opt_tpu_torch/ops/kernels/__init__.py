"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source in ``pde_opt_tpu_torch/csrc/`` exposes a plain C
interface; the ``*.cuh`` headers there hold device code they share.
:func:`load_library` compiles a source at first use with ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/`` at the repository root and loads
it with :mod:`ctypes`; the library's file name carries a hash of the source,
the headers and the flags, so an edited source is rebuilt.  Nothing is downloaded and
only sources of this package are compiled.  Importing this module compiles
nothing, so CPU-only machines can import every module of the port.

Every wrapper that launches a kernel adds one to its count with
:func:`count_launch`, and nowhere else, so a run can show that its main
path went through the kernels (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

__all__ = [
    "NVCC_FLAGS",
    "load_library",
    "load_libraries",
    "library_path",
    "build_log",
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
_LAUNCHES: Dict[str, int] = {
    "ch_cas_macro": 0, "ch_cas_macro_ep": 0, "ch_cas_macro_bwd": 0,
    # Of the two above, the launches that ran the on-chip kernel (128^2).
    "ch_cas_macro.onchip": 0,
    "ac_cas_macro": 0, "ac_cas_macro_ep": 0,
    "gpe_strang_macro": 0, "gpe_strang_macro_ep": 0,
    "bv_cc_macro": 0, "bv_cc_macro_ep": 0,
    # Of the two above, the launches that ran the tiled kernel (above 64^2).
    "bv_cc_macro.tiled": 0,
    "sbm_bv_macro": 0, "sbm_bv_macro_ep": 0,
    "ch_rhs_fd": 0, "ch3d_rhs_fd": 0,
    "ch_sif_macro": 0, "ac_sif_macro": 0,
    # The env fleet's auto-reset pass (csrc/fleet_reset.cu), one a fleet step.
    "vector_env.fleet_reset": 0,
}


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


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper only)."""
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
