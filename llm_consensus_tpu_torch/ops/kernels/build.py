"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, never at import (the CPU tests import every
module and there is no ``nvcc`` there), and lands in
``llm_consensus_tpu_torch/build/`` under a name that carries a hash of
the sources and flags, so an edited source is never served a stale
library. The ``.cu`` files are compiled in parallel (one ``nvcc`` each)
and then linked. A file lock makes concurrent first users (test workers)
build once.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (pointers and the stream are
# c_void_p: an untyped int would be cut to 32 bits).
_SIGNATURES = {
    "lct_rms_norm": (_P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _P),
    "lct_causal_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "lct_decode_attention": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "lct_shared_prefix_attention": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "lct_decode_attention_q8": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "lct_shared_prefix_attention_q8": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "lct_quant_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lct_quant4_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lct_quant_matmul_wg": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "lct_quant4_matmul_wg": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "lct_ragged_paged_attention": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(lib_path: Path) -> str:
    """Compile every source in parallel, link, and return nvcc's log."""
    nvcc = _nvcc()
    work = lib_path.with_suffix(".tmpdir")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append(
            (src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        )
    log = []
    failed = []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(log)
        )
    tmp_lib = work / lib_path.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    return "\n".join(log)


def library_path() -> Path:
    return BUILD_DIR / f"liblct_kernels-{_digest()}.so"


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                log = _compile(path)
                path.with_suffix(".log").write_text(log)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")
