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
where the wrapper launches its kernel and, for the launches it holds, by
each replay of a frame the Engine captured as a CUDA graph — the proof
that a run went through the kernels (chip_smoke.py resets and reads it).
The Engine's captures leave it as it was: a capture runs nothing, and the
eager warm-up before it delivers no frame.
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
                 "packet_intersect_binary": 0, "megakernel_trace_binary": 0,
                 "packet_intersect_sah2": 0, "megakernel_trace_sah2": 0,
                 "megakernel_trace_ftex": 0,
                 "megakernel_trace_binary_ftex": 0,
                 "megakernel_trace_sah2_ftex": 0,
                 "megakernel_trace_steps": 0,
                 "megakernel_trace_binary_steps": 0,
                 "megakernel_trace_sah2_steps": 0,
                 "post_tail": 0, "post_tail_mapped": 0, "denoise_wide": 0,
                 "reproject": 0, "reproject_bilinear": 0,
                 "reproject_band": 0, "reproject_bilinear_band": 0,
                 "probe_step": 0, "probe_leaf": 0, "probe_cores": 0,
                 "probe_cores_grid": 0, "probe_cond": 0,
                 "probe_smem_alloc": 0, "probe_smem_consume": 0,
                 "probe_pressure": 0, "probe_broadcast": 0,
                 "probe_xpose": 0, "probe_bf16": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures (the last argument of each is the cudaStream_t, but for
# the queries rtrt_smem_optin, a device attribute, and rtrt_traverse_stack,
# the traversal stack depths that have an instantiation)
_SIGNATURES = {
    "rtrt_traverse": [_P] * 8 + [_I, _I] + [_P] * 7 + [_I, _P, _P]
    + [_I] * 4 + [_P],
    "rtrt_traverse_stack": [ctypes.POINTER(_I), _I, _I, _I],
    "rtrt_megakernel": [_P] * 6 + [_I, _P, _I, _P] + [_F] * 4
    + [_P] * 6 + [_I, _I, _I] + [_P] * 4 + [_I, _P, _P] + [_I] * 5
    + [_P],
    "rtrt_post_tail": [_P, _I, _I, _P, _P, _I, _I, _I, _P] + [_P],
    "rtrt_denoise_wide": [_P] * 4 + [_I, _I, _P] + [_I] * 4 + [_F] * 3
    + [_P] + [_P],
    "rtrt_reproject": [_P] * 6 + [_I] * 6 + [_P] * 6 + [_P],
    "rtrt_probe_step": [_I, _P, _P, _P, _P, _I, _I, _I] + [_P],
    "rtrt_probe_leaf": [_I, _P, _P, _P, _I, _I] + [_P],
    "rtrt_probe_cores": [_I] + [_P] * 5 + [_I, _I, _I] + [_P],
    "rtrt_probe_cores_grid": [_I] + [_P] * 5 + [_I] * 4 + [_P],
    "rtrt_probe_cond": [_I, _P, _P, _P] + [_I] * 7 + [_P],
    "rtrt_probe_smem_alloc": [_P, _P, _I, _I] + [_P],
    "rtrt_smem_optin": [_I, ctypes.POINTER(_I)],
    "rtrt_probe_smem_consume": [_I, _P, _P, _P] + [_I] * 4 + [_P],
    "rtrt_probe_pressure": [_I] + [_P] * 4 + [_I] * 4 + [_P],
    "rtrt_probe_broadcast": [_I] + [_P] * 4 + [_I, _I, _I] + [_P],
    "rtrt_probe_xpose": [_I, _P, _P, _P] + [_I] * 4 + [_P],
    "rtrt_probe_bf16": [_I, _P, _P, _F] + [_I] * 4 + [_P],
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


def traverse_stacks(arity: int = 4, leaf_width: int = 8) -> tuple:
    """The traversal stack depths (entries) that K1 and K2 are instantiated
    for on trees of (`arity`, `leaf_width`) ((4, 8): the BVH4, (2, 1): the
    two-level LBVH, (2, 8): the flat binary SAH tree), as the library
    reports them."""
    depths = (_I * 8)()
    n = library().rtrt_traverse_stack(depths, 8, arity, leaf_width)
    return tuple(depths[:n])


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


def check_aligned(**tensors):
    """Raises ValueError, before any launch, on a tensor whose first
    element is not 16-byte aligned (a kernel that reads it by 16-byte
    vectors or bulk copies would fault or read the wrong bytes)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned (address "
                             f"{t.data_ptr():#x})")


def launch(fn, name: str, device, *args, refusal: int | None = None) -> bool:
    """Call C entry `fn` with tensors passed as device pointers and the
    current stream appended; raise on a nonzero cudaGetLastError().

    refusal: a status the entry point returns when the runtime refused the
    launch as a result (not a failure); then nothing launched and the call
    returns False.  Returns True when the kernel launched."""
    dev = torch.device(device)
    cargs = [_P(a.data_ptr()) if torch.is_tensor(a) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*cargs, _P(stream))
    if refusal is not None and rc == refusal:
        return False
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {rc}")
    launch_counts[name] += 1
    return True
