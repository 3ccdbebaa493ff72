"""Build, bind and launch the hand-written CUDA kernels of csrc/.

All ``csrc/*.cu`` files are compiled by nvcc, one process per source, all
started together, and linked into ONE shared library with a plain C
interface (no PyTorch headers: a build takes seconds, not minutes), keyed
by a hash of the sources and flags, under ``build/rtrt_tpu_torch/`` at the
repository root, at first use.  The library is loaded with ctypes;
every pointer and the stream go over as ``c_void_p``.  Each C entry point
launches on the given stream and returns ``cudaGetLastError()``; `launch`
raises if it is not 0.

`launch_counts` holds one plain integer per kernel wrapper, incremented
where the wrapper launches its kernel and nowhere else — the proof that a
run went through the kernels (chip_smoke.py resets and reads it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rtrt_tpu_torch"
# no --use_fast_math: powf/expf/sqrtf and divisions stay IEEE-accurate
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts = {"packet_intersect": 0, "megakernel_trace": 0,
                 "post_tail": 0, "denoise_wide": 0, "reproject": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# C signatures (the last argument of each is the cudaStream_t)
_SIGNATURES = {
    "rtrt_traverse": [_P] * 8 + [_I, _I] + [_P] * 8 + [_P],
    "rtrt_megakernel": [_P] * 6 + [_I, _P, _I, _P] + [_F] * 4 + [_U]
    + [_P] * 5 + [_I, _I, _I] + [_P, _P] + [_P],
    "rtrt_post_tail": [_P, _I, _I, _P, _P, _I, _I, _P] + [_P],
    "rtrt_denoise_wide": [_P] * 4 + [_I, _I, _P] + [_I] * 4 + [_F] * 3
    + [_P] + [_P],
    "rtrt_reproject": [_P] * 6 + [_I, _I, _I] + [_P] * 6 + [_P],
}

_lib = None
build_info: dict = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "host with the CUDA toolkit")
    return path


def build() -> Path:
    """Compile csrc/*.cu into the hashed shared library (once)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"librtrt_kernels_{digest.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True,
                          log=log.read_text() if log.exists() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(src.name, p.returncode, text)
              for src, p, text in zip(sources, procs, logs) if p.returncode]
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode:
            failed.append(("link", link.returncode,
                           link.stdout + link.stderr))
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{text}" for name, rc, text in failed))
    os.replace(tmp, out)
    text = "".join(logs)
    log.write_text(text)
    build_info.update(path=str(out), seconds=seconds, cached=False, log=text)
    return out


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_tensors(device, **specs):
    """specs: name -> (tensor, dtype, shape).  Raises on a tensor that is
    not on `device`, of another dtype or shape, or not contiguous."""
    for name, (t, dtype, shape) in specs.items():
        if t.device != torch.device(device):
            raise ValueError(f"{name}: on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")


def launch(fn, name: str, device, *args):
    """Call C entry `fn` with tensors passed as device pointers and the
    current stream appended; raise on a nonzero cudaGetLastError()."""
    dev = torch.device(device)
    cargs = [_P(a.data_ptr()) if torch.is_tensor(a) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*cargs, _P(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {rc}")
    launch_counts[name] += 1
