"""Build of the port's CUDA sources into shared libraries loaded by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so one ``nvcc`` call takes seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

``fused_loop.cu`` launches one cooperative kernel
(``cudaLaunchCooperativeKernel`` with a cooperative-groups grid barrier);
with CUDA 11 and later that needs no relocatable device code, so it
builds with the same flags and no ``-rdc``.

The library goes into ``_build/kernels/`` beside this package (a directory
that git ignores), named by a hash of the source, of the shared headers
(``csrc/*.cuh``), of ``NVCC_FLAGS`` and of the compiler's ``--version``
text, so an edited source, a new flag or another toolkit is rebuilt and
an unchanged tree on the same toolkit is not. This is the counterpart of
the JAX package's compile cache, whose directory is keyed on the machine
(yabpe_tpu/utils/jaxsetup.py): a library built by another toolchain is
never loaded. A file lock serializes concurrent builds. A failed build
raises :class:`KernelBuildError`; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_version_lock = threading.Lock()
_nvcc_version: str | None = None


class KernelBuildError(RuntimeError):
    """A CUDA source did not compile or its library did not load."""


def nvcc_path() -> str:
    """The nvcc to use: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return found


def nvcc_version() -> str:
    """The compiler's ``--version`` text, read once per process."""
    global _nvcc_version
    with _version_lock:
        if _nvcc_version is None:
            cmd = [nvcc_path(), "--version"]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise KernelBuildError(f"{cmd[0]} could not run: {e}") from e
            if proc.returncode != 0:
                raise KernelBuildError(f"{' '.join(cmd)} failed with code {proc.returncode}")
            _nvcc_version = proc.stdout
        return _nvcc_version


def library_path(name: str, version: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` built by the compiler whose
    ``--version`` text is ``version`` lives."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    h.update(version.encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` if its library is missing.

    Returns (library path, the compiler's output: the ``-Xptxas -v``
    register and shared-memory lines, empty when nothing was compiled).
    """
    src = CSRC / f"{name}.cu"
    out = library_path(name, nvcc_version())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if out.exists():
            return out, ""
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise KernelBuildError(f"{cmd[0]} could not run: {e}") from e
        if proc.returncode != 0:
            raise KernelBuildError(
                f"{' '.join(cmd)} failed with code {proc.returncode}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        tmp.replace(out)
        return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = build(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _libs[name] = lib
        return lib


__all__ = ["KernelBuildError", "build", "load", "library_path", "nvcc_path", "nvcc_version"]
