"""Build and load the hand-written Hopper kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an
object (one compiler process per source, all started together), the
objects are linked into one shared library with a plain C interface,
and the library is loaded with ``ctypes``. No PyTorch header is
included, so a build takes seconds. The library lands in ``build/``
beside this module, named by a hash of the sources and flags, and is
built at first use — never when a module is imported.

Each C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"] + ARCH_FLAGS

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: name -> argument types (return: int)
SIGNATURES = {
    "grouped_ffn": [_P] * 8 + [_I] * 5 + [_P],
    "grouped_ffn_bwd": [_P] * 14 + [_I] * 6 + [_P],
    "moe_ffn": [_P] * 5 + [_I] + [_P] * 4 + [_I] * 8 + [_P],
    "moe_ffn_bwd": [_P] * 5 + [_I] + [_P] * 9 + [_I] * 8 + [_P],
    "moe_ffn_bwd_parts": [_I] * 5,
    "decode_attention": [_P] * 6 + [_I] * 12 + [ctypes.c_float, _I, _P],
    "decode_attention_step": [_I, _I],
    "ssd_scan": [_P] * 10 + [_I] * 8 + [_P],
    "ssd_scan_bwd": [_P] * 24 + [_I] * 8 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""   # ptxas register / shared-memory report of the last build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library;
    returns its path. A library already built from the same sources is
    reused."""
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libxshare_kernels_{_digest()}.so"
    if out.exists():
        return out
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        t0 = time.perf_counter()
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            log = open(Path(tmp) / (src.stem + ".log"), "w+")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        # each unit's wall time from the common start, for the report
        ended = {}
        while len(ended) < len(procs):
            for src, _, _, p in procs:
                if src.name not in ended and p.poll() is not None:
                    ended[src.name] = time.perf_counter() - t0
            time.sleep(0.05)
        logs, failed = [], []
        for src, _, log, p in procs:
            log.seek(0)
            logs.append(f"== {src.name} ({ended[src.name]:.1f} s)\n"
                        f"{log.read()}")
            log.close()
            if p.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
             *[str(o) for _, o, _, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed:\n{link.stdout}")
        os.replace(tmp_so, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


# Where a wrapper takes its kernel's plain version: the CPU, and the meta
# device, on which the plain version only propagates shapes and dtypes
# (a step traced at full size for its shapes, launch/dryrun.py). A CUDA
# tensor takes the kernel or the wrapper raises.
PLAIN_DEVICES = ("cpu", "meta")

DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(t) -> int:
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[name]


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel without a backward would drop a gradient: the
    output of a launch is written through a pointer and has no grad_fn,
    so under autograd a tensor that requires grad must not reach it."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            f"requires grad; run it under torch.no_grad(), or train on a "
            f"path with a gradient")
