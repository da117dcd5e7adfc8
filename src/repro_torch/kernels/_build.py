"""Build and load the CUDA kernels: ``nvcc`` -> shared library -> ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own, with a plain C
interface, for ``sm_90a``, into ``build/repro_torch/`` at the root of
the checkout (``REPRO_TORCH_BUILD_DIR`` overrides).  Library names
carry a hash of the sources they include, so an edited source is
rebuilt and an unchanged one is loaded as it is.  ``build_all()``
starts one ``nvcc`` per source, all together.  Nothing here runs at
import: the first kernel launch builds what it needs.

Every exported launcher takes its pointers and the stream as
``ctypes.c_void_p`` (never a 32-bit int) and returns
``cudaGetLastError()`` right after its launch; ``check()`` turns a
non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_HEADERS = ("common.cuh", "tile_gemm.cuh")

#: source file -> exported launchers and their ctypes signatures
_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARIES: Dict[str, Dict[str, Sequence]] = {
    "cuconv_fused": {
        # x, w, bias, addend, out, dtype, N, H, W, C, KH, KW, M, sh, sw,
        # ph, pw, OH, OW, tm, rows, relu, pool_kind, psh, psw, smem, stream
        "cuconv_fused_launch": [_P] * 5 + [_I] * 21 + [_P],
    },
    "conv1x1": {
        # x2d, w, out, dtype, P, C, M, tp, tm, tc, smem, stream
        "conv1x1_gemm_launch": [_P] * 3 + [_I] * 8 + [_P],
    },
    "cuconv_stage1": {
        # xs, w, out, dtype, T, P, C, M, tp, tm, tc, smem, stream
        "stage1_tap_gemm_launch": [_P] * 3 + [_I] * 9 + [_P],
    },
    "cuconv_stage2": {
        # temps, out, out_dtype, T, PM, stream
        "stage2_tap_sum_launch": [_P] * 2 + [_I] * 3 + [_P],
    },
}

#: launches per kernel: each wrapper adds one where it launches its
#: kernel, and nowhere else (a run shows it went through the kernels)
LAUNCHES: Dict[str, int] = {"cuconv_fused": 0, "conv1x1_gemm": 0,
                            "stage1_tap_gemm": 0, "stage2_tap_sum": 0}

#: what the last build did, per library: seconds and ptxas's report
BUILD_LOG: Dict[str, Dict] = {}

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the "
                       "repro_torch CUDA kernels are built from source")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in (f"{name}.cu",) + _HEADERS:
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list:
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names: Sequence[str] = tuple(LIBRARIES)) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together; returns seconds per library built."""
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, path)
    done = {}
    errors = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        secs = time.perf_counter() - t0
        BUILD_LOG[name] = {"seconds": secs, "ptxas": out}
        if proc.returncode != 0:
            errors.append(f"--- nvcc {name}.cu failed ---\n{out}")
            continue
        os.replace(tmp, path)       # atomic: concurrent builders agree
        done[name] = secs
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in LIBRARIES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LOADED[name] = lib
    return lib


def check(name: str, kernel: str, code: int) -> None:
    """Raise if a launcher reported a non-zero ``cudaGetLastError()``."""
    if code != 0:
        msg = library(name).repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} "
                           f"({msg})")


def stream_of(t) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``t``'s card."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


#: dtype codes of the C interface
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

#: shared memory one block may use on Hopper (sm_90: 227 KB)
SMEM_LIMIT = 232_448


def on_card(kernel: str, t) -> bool:
    """Where a wrapper runs: False for a CPU tensor (the plain version),
    True for a CUDA tensor (the kernel); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{kernel}: tensors on {t.device} are not supported "
                     f"(cuda runs the kernel, cpu its plain version)")


def check_operands(kernel: str, device, dtype, **tensors) -> None:
    """Every operand on one device, in one dtype, contiguous."""
    import torch
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel}: dtype {dtype} not supported "
                         f"(float32 or bfloat16)")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device} but the "
                             f"input is on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} has dtype {t.dtype} but the "
                             f"input has {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def check_smem(kernel: str, smem: int, what: str) -> None:
    if smem > SMEM_LIMIT:
        raise ValueError(f"{kernel}: {what} stages {smem} bytes of shared "
                         f"memory > {SMEM_LIMIT} a block can use")
