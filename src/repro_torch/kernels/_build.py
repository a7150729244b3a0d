"""Build the port's CUDA kernels at first use.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain `extern "C"` interface, loaded through ctypes.  Libraries go into
`build/kernels/` at the repository root (git-ignored), keyed by a hash of
the sources and the flags, so an edited source builds anew and an
unchanged one is reused.  Only the sources in this package are compiled.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit on PATH or under $CUDA_HOME")


def source_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` lives, keyed by content."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (default: all) whose library is missing,
    one nvcc process per source, all started together.  Returns name ->
    the compiler's report (`-Xptxas -v`: registers, shared memory and
    spills per kernel).  Raises with the compiler's output on failure."""
    names = source_names() if names is None else names
    todo = [name for name in names if not library_path(name).exists()]
    if todo:
        exe = nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in todo:
        lib = library_path(name)
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(lib.with_suffix(".log"), "w") as log:
            running[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                             tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in running.items():
        rc = proc.wait()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + lib.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    reports = {}
    for name in names:
        log = library_path(name).with_suffix(".log")
        reports[name] = log.read_text() if log.exists() else ""
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if missing."""
    lib = library_path(name)
    if not lib.exists():
        build([name])
    return ctypes.CDLL(str(lib))
