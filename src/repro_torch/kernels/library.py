"""Build and load the port's CUDA kernels.

Every source under ``repro_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` (one compiler process per source, all started together) and
linked into one shared library with a plain C interface, loaded with
``ctypes``. The build happens at first use, on the machine with the card,
into ``build/repro_torch_kernels/`` at the repository root; the library's
name carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged tree reuses what is there. Nothing is built or loaded when
this module is imported.

Launchers take raw device pointers and the caller's stream, return
``cudaGetLastError()``, and :func:`launch` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH]

FLOAT32, BFLOAT16 = 0, 1          # dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: FLOAT32, torch.bfloat16: BFLOAT16}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "wq_claim_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "wq_claim_scratch_ints": ([_I, _I], ctypes.c_longlong),
    "flash_attention_launch": (
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P], _I),
    "decode_attention_launch": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P], _I),
    "decode_attention_scratch_floats": ([_I, _I, _I, _I], ctypes.c_longlong),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the repro_torch kernels")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless it exists; returns its path.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library as ``<name>.log``. A build goes
    to a private temporary directory and is moved into place atomically, so
    processes that build at once do not see each other's partial files.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    sources, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp_", dir=BUILD_DIR))
    try:
        objs = [tmp / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{src.name}:\n{log}" for src, p, log
                  in zip(sources, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp / out.name),
             *map(str, objs)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "build.log").write_text(
            "".join(f"== {s.name}\n{log}" for s, log in zip(sources, logs)))
        os.replace(tmp / "build.log", out.with_suffix(".log"))
        os.replace(tmp / out.name, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded library (built on first use), with its C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call launcher ``name``; raise if the launch was refused."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current stream on ``t``'s device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
