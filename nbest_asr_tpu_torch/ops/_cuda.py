"""Build and load the port's hand-written CUDA kernels; launch counters.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for ``sm_90a``,
all started together, and the objects link into ONE shared library with
a plain C interface, loaded with ctypes.  The library name carries a hash
of the sources and flags, so an edit rebuilds and an unchanged checkout
reuses the library in ``build/nbest_asr_tpu_torch/`` (git-ignored).  The
build runs on first use -- never at import -- and a failure raises with
nvcc's stderr.  ``-Xptxas -v`` makes ptxas report each kernel instance's
registers, shared memory and spills; ``build_report`` keeps those lines
and ptxas's notes on serialised ``wgmma`` and ignored ``setmaxnreg``.

``launch_counts`` counts, per kernel, the launches made by the wrappers
in ``ops/kernels.py`` (plain integers, incremented only where a kernel is
launched), so a run can show that its path really went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "nbest_asr_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("gemm_bias_act", "gemm_bias_residual", "layer_norm",
           "seg_attention", "quantize_rows", "gemm_i8_bias_act",
           "gemm_i8_bias_residual", "ffn_bwd_rows", "gemm_dgrad",
           "seg_attention_bwd", "quantize_grad_rows", "gemm_i8_dgrad",
           "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "residual_layer_norm", "residual_layer_norm_bwd", "bias_gelu",
           "bias_gelu_bwd", "embed_lookup")
launch_counts = {name: 0 for name in KERNELS}
# the build's lines worth keeping: ptxas's resources and spills per kernel
# instance, and its notes on wgmma serialised ("Potential Performance
# Loss") or setmaxnreg ignored
NOTE_KEYS = ("wgmma.mma_async", "Performance Loss", "setmaxnreg")
REPORT_KEYS = ("ptxas info", "spill", *NOTE_KEYS)

_lib = None
build_seconds = None      # wall time of the nvcc build this process ran
build_report = []         # ptxas resource lines of that build, per source


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnbest_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    logs = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                 for s, o in zip(srcs, objs)])
    build_report[:] = [f"{src.name}: {line.strip()}"
                       for src, log in zip(srcs, logs)
                       for line in log.splitlines()
                       if any(k in line for k in REPORT_KEYS)]
    _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def _run(cmds) -> list:
    """Run the commands in parallel; wait for all, then raise with the
    stderr of each that failed; returns each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = [(c, p.communicate()[1], p.returncode)
            for c, p in zip(cmds, procs)]
    bad = [f"nvcc failed ({rc}):\n{' '.join(c)}\n{err}"
           for c, err, rc in errs if rc != 0]
    if bad:
        raise RuntimeError("\n".join(bad))
    return [err for _, err, _ in errs]


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    L = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # a dropout site: seed, stream, threshold, inv_keep, on (philox.cuh)
    drop = [ctypes.c_uint64, i, ctypes.c_uint32, f, i]
    L.nbk_gemm_bias_act.argtypes = [p, p, p, p, p, i, i, i, i, *drop, p]
    L.nbk_gemm_bias_residual.argtypes = [p, p, p, p, p, p, i, i, i, *drop,
                                         p]
    L.nbk_gemm_dgrad.argtypes = [p, p, p, p, p, p, i, i, i, i, *drop, p]
    L.nbk_layer_norm.argtypes = [p, p, p, p, p, p, i, i, f, p]
    L.nbk_ffn_bwd_rows.argtypes = [p] * 9 + [i, i, *drop, p]
    # q, k, v, their row stride (single-block and tiled attention)
    qkv = [p, p, p, i]
    # ..., d, the instance (0: wgmma, else the mma.sync width), sm_scale
    L.nbk_seg_attention.argtypes = [*qkv, p, p, p, i, i, i, i, i, f, *drop,
                                    p]
    L.nbk_seg_attention_bwd.argtypes = [*qkv] + [p] * 7 + [i] * 6 + [
        f, *drop, p]
    L.nbk_flash_fwd.argtypes = [*qkv, p, p, p, i, i, i, i, f, *drop, p]
    L.nbk_flash_bwd_dq.argtypes = [*qkv] + [p] * 6 + [i] * 5 + [f, *drop, p]
    L.nbk_flash_bwd_dkv.argtypes = [*qkv] + [p] * 6 + [i] * 5 + [f, *drop,
                                                                 p]
    # the chunked family (any head dim; the single-block wrappers call it,
    # the tiled entry points above hand it the chunked head dims
    # themselves): ..., st0, st1, tiled, B, S, n_heads, d, sm_scale; the
    # backward pair's o (dq) or dout first
    L.nbk_chunked_fwd.argtypes = [*qkv, p, p, p, p] + [i] * 5 + [f, *drop,
                                                                p]
    L.nbk_chunked_bwd_dq.argtypes = [*qkv] + [p] * 7 + [i] * 5 + [
        f, *drop, p]
    L.nbk_chunked_bwd_dkv.argtypes = [*qkv] + [p] * 7 + [i] * 5 + [
        f, *drop, p]
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        getattr(L, f"nbk_chunked_{name}").restype = ctypes.c_int
    L.nbk_chunked_launches.argtypes = [i]
    L.nbk_chunked_launches.restype = ctypes.c_longlong
    L.nbk_chunked_fwd_instance_launches.argtypes = [i]
    L.nbk_chunked_fwd_instance_launches.restype = ctypes.c_longlong
    L.nbk_quantize_rows.argtypes = [p, p, p, i, i, i, p]
    L.nbk_quantize_grad_rows.argtypes = [p, p, p, p, i, i, i, *drop, p]
    L.nbk_gemm_i8_bias_act.argtypes = [p] * 7 + [i, i, i, i, *drop, p]
    L.nbk_gemm_i8_bias_residual.argtypes = [p] * 8 + [i, i, i, *drop, p]
    L.nbk_gemm_i8_dgrad.argtypes = [p] * 8 + [i, i, i, i, *drop, p]
    # the row kernels: ..., is_f32 (bf16 or f32 activations), stream
    L.nbk_residual_layer_norm.argtypes = [p] * 7 + [i, i, f, i, p]
    L.nbk_residual_layer_norm_bwd.argtypes = [p] * 10 + [i, i, i, i, p]
    L.nbk_bias_gelu.argtypes = [p, p, p, i, i, i, p]
    L.nbk_bias_gelu_bwd.argtypes = [p, p, p, p, i, i, i, p]
    L.nbk_embed_lookup.argtypes = [p] * 8 + [i, i, i, i, i, f, i, p]
    for name in KERNELS:
        getattr(L, f"nbk_{name}").restype = ctypes.c_int
    L.nbk_seg_attention_wgmma_launches.argtypes = [i]
    L.nbk_seg_attention_wgmma_launches.restype = ctypes.c_longlong
    L.nbk_seg_attention_bwd_wgmma_launches.argtypes = [i]
    L.nbk_seg_attention_bwd_wgmma_launches.restype = ctypes.c_longlong
    L.nbk_flash_fwd_wgmma_launches.argtypes = [i]
    L.nbk_flash_fwd_wgmma_launches.restype = ctypes.c_longlong
    L.nbk_flash_bwd_wgmma_launches.argtypes = [i, i]
    L.nbk_flash_bwd_wgmma_launches.restype = ctypes.c_longlong
    L.nbk_quantize_rows_pass_launches.argtypes = [i]
    L.nbk_quantize_rows_pass_launches.restype = ctypes.c_longlong
    L.nbk_quantize_grad_rows_pass_launches.argtypes = [i]
    L.nbk_quantize_grad_rows_pass_launches.restype = ctypes.c_longlong
    L.nbk_error_string.argtypes = [i]
    L.nbk_error_string.restype = ctypes.c_char_p
    _lib = L
    return L


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (refused launches never run
    and a later synchronize would not report them)."""
    if rc != 0:
        msg = lib().nbk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
