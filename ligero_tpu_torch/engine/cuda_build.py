"""Build and load the port's hand-written Hopper kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` (one process per source, all
started together) into one shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The library
is built at first use and cached by a hash of the sources and flags, as
``native`` does for the host kernels.  The build directory is
``ligero_tpu_torch/_build/`` (git-ignored).

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on a non-zero code.  Pointers and the stream travel as
``c_void_p``.  The field kernels (NTT, mont_mul, Blake2s columns,
row_combine) are templates over the field, built for BN254 Fr and
BLS12-377 Fq, and take the field's id (:data:`KERNEL_FIELDS`,
:func:`kernel_field_id`) as their first argument.  The Poseidon sponge
(``poseidon_cols.cu``) is built for BN254 Fr only: its 32-byte digests hold
no BLS12-377 element.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..fields import BLS12_377_FQ, BN254_FR

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libligero_cuda.so")
LOG_PATH = os.path.join(BUILD_DIR, "nvcc.log")
_HASH_PATH = LIB_PATH + ".srchash"

#: nvcc command line (part of the cache key)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: the fields the kernels are built for, and the id of each: the field
#: argument of the C entry points (the trait ``ID`` of csrc/field.cuh)
KERNEL_FIELDS = {BN254_FR: 0, BLS12_377_FQ: 1}

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signatures of the entry points (all return an int cudaError_t)
_SIGNATURES = {
    "lt_mont_mul": [_i, _vp, _vp, _vp, _ll, _i, _vp],
    "lt_ntt_pass": [_i, _i, _vp, _vp, _vp, _vp, _vp, _i, _ll, _i, _i, _i, _i,
                    _i, _i, _i, _vp],
    "lt_ntt_stage": [_i, _vp, _vp, _vp, _ll, _i, _i, _i, _i, _vp],
    "lt_blake2s_cols": [_i, _vp, _ll, _ll, _ll, _vp, _vp],
    "lt_blake2s_absorb": [_i, _vp, _ll, _ll, _vp, _ll, _i, _ll, _vp],
    "lt_row_combine": [_i, _vp, _vp, _vp, _vp, _ll, _ll, _ll, _ll, _ll, _i,
                       _vp],
    "lt_sha256_tree": [_vp, _ll, _vp, _vp, _i, _vp],
    "lt_sha256_chain_probe": [_vp, _i, _vp],
    "lt_poseidon_cols": [_vp, _vp, _ll, _ll, _ll, _ll, _ll, _ll, _i, _vp,
                         _vp],
    "lt_poseidon_absorb": [_vp, _vp, _ll, _ll, _ll, _ll, _vp, _i, _i, _i, _vp,
                           _vp],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class CudaKernelError(RuntimeError):
    """A kernel library build, load or launch failed."""


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise CudaKernelError("nvcc not found (PATH, $CUDA_HOME/bin, "
                          "/usr/local/cuda/bin)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _build(want: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    cu = [p for p in _sources() if p.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(p)}.{pid}.o")
            for p in cu]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj, src]
            for src, obj in zip(cu, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    tmp = f"{LIB_PATH}.{pid}.tmp"
    link = [nvcc, "-shared", "-o", tmp, *objs]
    failed = [(cmd, err) for cmd, proc, (_, err) in zip(cmds, procs, outs)
              if proc.returncode != 0]
    res = None if failed else subprocess.run(link, capture_output=True,
                                             text=True)
    with open(LOG_PATH, "w") as f:
        for cmd, (out, err) in zip(cmds, outs):
            f.write(" ".join(cmd) + "\n" + out + err)
        if res is not None:
            f.write(" ".join(link) + "\n" + res.stdout + res.stderr)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        cmd, err = failed[0]
        raise CudaKernelError(f"nvcc failed: {' '.join(cmd)}\n{err[-4000:]}")
    if res.returncode != 0:
        raise CudaKernelError(f"nvcc link failed ({res.returncode}):\n"
                              f"{res.stderr[-4000:]}")
    os.replace(tmp, LIB_PATH)
    with open(_HASH_PATH, "w") as f:
        f.write(want)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if the sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        want = source_hash()
        have = None
        if os.path.exists(LIB_PATH) and os.path.exists(_HASH_PATH):
            with open(_HASH_PATH) as f:
                have = f.read().strip()
        if have != want:
            _build(want)
        lib = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def kernel_field_id(field, name: str) -> int:
    """The id the field kernels take for ``field``; raises
    ``NotImplementedError`` for a field they are not built for."""
    for known, fid in KERNEL_FIELDS.items():
        if (field.name, field.p) == (known.name, known.p):
            return fid
    raise NotImplementedError(
        f"{name}: the CUDA kernels implement "
        f"{' and '.join(f.name for f in KERNEL_FIELDS)} only, not {field.name}")


def check(code: int, name: str) -> None:
    if code != 0:
        raise CudaKernelError(f"{name}: CUDA error {code}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_tensors(name: str, *tensors) -> None:
    """Kernels take contiguous int32 tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


class LaunchCounter:
    """Number of times a wrapper launched its kernel."""

    def __init__(self):
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0
