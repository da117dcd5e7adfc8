"""Build and load the CUDA kernels: ``nvcc`` -> shared library -> ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own, with a plain C
interface, for ``sm_90a``, into ``build/repro_torch/`` at the root of
the checkout (``REPRO_TORCH_BUILD_DIR`` overrides).  Library names
carry a hash of the sources they include, so an edited source is
rebuilt and an unchanged one is loaded as it is.  ``build_all()``
starts one ``nvcc`` per source, all together.  Nothing here runs at
import: the first kernel launch builds what it needs.

Every exported launcher takes its pointers and the stream as
``ctypes.c_void_p`` (never a 32-bit int), a float as ``ctypes.c_float``,
and returns ``cudaGetLastError()`` right after its launch; ``check()``
turns a non-zero code into an exception.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_HEADERS = ("common.cuh", "mma_tf32.cuh", "splitk.cuh")

#: source file -> exported launchers and their ctypes signatures
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARIES: Dict[str, Dict[str, Sequence]] = {
    "cuconv_fused": {
        # x, w, bias, addend, out, ws, counters, dtype, N, H, W, C, KH, KW,
        # M, sh, sw, ph, pw, OH, OW, relu, pool_kind, psh, psw, th, tw, bm,
        # bn, tiles, splits, vec_a, vec_b, smem, stream
        "cuconv_fused_launch": [_P] * 7 + [_I] * 27 + [_P],
    },
    "conv1x1": {
        # x2d, w, out, ws, counters, dtype, P, C, M, bm, splits, vec,
        # smem, stream
        "conv1x1_gemm_launch": [_P] * 5 + [_I] * 8 + [_P],
    },
    "cuconv_stage1": {
        # x, w, out, dtype, T, P, C, M, KW, tap_row, tap_col, OHW, OW, img,
        # row, bm, bn, tiles, vec_a, vec_b, smem, stream
        "stage1_tap_gemm_launch": [_P] * 3 + [_I] * 18 + [_P],
    },
    "cuconv_stage2": {
        # temps, out, out_dtype, T, PM, cols, rows, blocks, vec_in,
        # vec_out, unroll, stream
        "stage2_tap_sum_launch": [_P] * 2 + [_I] * 9 + [_P],
        # stream: an empty kernel, the launch floor
        "empty_launch": [_P],
    },
    "winograd_fused": {
        # x, w, bias, addend, out, dtype, N, H, W, C, M, ph, pw, OH, OW,
        # m, bn, vec, relu, smem, stream
        "winograd_fused_launch": [_P] * 5 + [_I] * 15 + [_P],
    },
    "direct_conv": {
        # x, w, out, ws, counters, dtype, N, H, W, C, KH, KW, M, sh, sw, ph,
        # pw, OH, OW, th, tw, bm, bn, kc, stages, tiles, splits, vec_a,
        # vec_b, smem, stream
        "direct_conv_launch": [_P] * 5 + [_I] * 25 + [_P],
    },
    "int8_gemm": {
        # x, w, out, scale, wscale, bias, addend, in_float, w_km, N, H, W,
        # C, KH, KW, M, sh, sw, ph, pw, OH, OW, bm, bn, kc, relu, vec_a,
        # vec_b, smem, stream
        "int8_gemm_launch": [_P] * 7 + [_I] * 22 + [_P],
    },
    "flash_attention": {
        # q, k, v, out, dtype, B, Sq, Sk, H, KVH, D, dp, scale, causal,
        # smem, stream
        "flash_attention_launch": [_P] * 4 + [_I] * 8 + [_F] + [_I] * 2
                                  + [_P],
    },
    "conv1d_tap": {
        # x, w, bias (or NULL), y, dtype, B, L, D, K, stream
        "conv1d_tap_launch": [_P] * 4 + [_I] * 5 + [_P],
    },
}

#: launches per kernel: each wrapper adds one where it launches its
#: kernel, and nowhere else (a run shows it went through the kernels)
LAUNCHES: Dict[str, int] = {"cuconv_fused": 0, "conv1x1_gemm": 0,
                            "stage1_tap_gemm": 0, "stage2_tap_sum": 0,
                            "winograd_fused": 0, "direct_conv": 0,
                            "int8_gemm": 0, "flash_attention": 0,
                            "conv1d_tap": 0}

#: what the last build did, per library: seconds and ptxas's report
BUILD_LOG: Dict[str, Dict] = {}

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Count launches that ran without their wrappers: a CUDA graph's
    replay adds what its capture recorded."""
    for k, n in counts.items():
        LAUNCHES[k] += n


#: the records of the CUDA-graph captures in progress (innermost last)
_CAPTURES: List[Dict] = []


@contextlib.contextmanager
def graph_capture():
    """Around a CUDA-graph capture.  The wrappers count the launches they
    record, but nothing runs: on exit ``LAUNCHES`` is put back, and the
    yielded record's ``"launches"`` holds what was recorded, per kernel.
    Its ``"keep"`` collects what ``keep_for_graph`` was given during the
    capture, for the graph's owner to hold as long as the graph.

    The garbage collector runs before the capture and is held off during
    it: a CUDA graph destroyed during a capture (one held by a reference
    cycle that the collector frees) invalidates the capture."""
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    before = dict(LAUNCHES)
    rec: Dict = {"launches": {}, "keep": []}
    _CAPTURES.append(rec)
    try:
        yield rec
    finally:
        _CAPTURES.pop()
        rec["launches"].update({k: LAUNCHES[k] - n for k, n in before.items()
                                if LAUNCHES[k] != n})
        LAUNCHES.update(before)
        if collecting:
            gc.enable()


def keep_for_graph(*tensors) -> None:
    """A tensor that a cache hands to a kernel, and may drop later: if a
    CUDA graph is being captured, it reads that memory on every replay,
    so its owner must hold the tensor."""
    if _CAPTURES:
        _CAPTURES[-1]["keep"].extend(tensors)


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


def flop_formula(op, formula) -> None:
    """Register ``formula(*input shapes)`` as the FLOPs of the custom op
    ``op`` with ``torch.utils.flop_counter``, so a counter sees a
    kernel's work whether it runs on the card or on meta."""
    from torch.utils.flop_counter import register_flop_formula
    register_flop_formula(op._opoverload.overloadpacket)(
        lambda *shapes, out_shape=None, **kw: formula(*shapes))


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise where a kernel would be launched on an input that requires
    grad with grad mode on: the kernels have no backward, so their
    output would carry no gradient while the plain version's does."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and the kernel has no "
            f"backward; differentiate through its plain version (train "
            f"mode does) or call it under torch.no_grad()")


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
