"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``mem_tpu_torch/csrc/*.cu`` is compiled to an object file, one nvcc
process per source and all of them started together, and the objects are
linked into one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o _build/<name>_<hash>.o csrc/<name>.cu
    nvcc -shared -o _build/libmem_kernels_<hash>.so _build/*_<hash>.o

The library lands in ``mem_tpu_torch/_build/`` (git-ignored), named by a
hash of the sources and the flags, so an unchanged tree loads the cached
build and an edited one rebuilds. The ptxas report (registers, shared
memory, spills per kernel) is kept beside it as ``build_<hash>.log``.

No PyTorch header is compiled: pointers (``Tensor.data_ptr()``) and the
stream (``torch.cuda.current_stream().cuda_stream``) cross as Python ints,
so every pointer and the stream are declared ``c_void_p``. Each C entry
point returns ``cudaGetLastError()`` after its launch; :func:`check` turns a
non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> (argtypes, restype)
SIGNATURES = {
    "mem_hist_planes_cols": ((_P, _P, _P, _I, _I, _I, _I, _P), _I),
    "mem_hist_planes_cols_sorted": ((_P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "mem_hist_sorted_band_rows": ((_I, _I, _I), _I),
    "mem_hist_sorted_chunks": ((_I,), _I),
    "mem_attention_fwd_flat": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P), _I),
    "mem_attention_fwd_flat_smem": ((_I, _I, _I), ctypes.c_longlong),
    "mem_attention_bwd_flat": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _F, _I, _P), _I),
    "mem_attention_bwd_flat_smem": ((_I, _I, _I), ctypes.c_longlong),
    "mem_attention_bwd_flat_mma": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _F, _I, _P), _I),
    "mem_attention_fwd_bhnd": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P), _I),
    "mem_attention_bwd_bhnd": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _F, _I, _P), _I),
    "mem_mlp_fwd": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "mem_mlp_fwd_uses_mma": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I), _I),
    "mem_mlp_rows_smem": ((_I, _I, _I), ctypes.c_longlong),
    "mem_mlp_bwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "mem_mlp_bwd_uses_mma": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I), _I),
    "mem_attention_long_fwd": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P), _I),
    "mem_attention_long_fwd_max_d": ((), _I),
    "mem_attention_long_fwd_uses_mma": ((_P, _P, _P, _P, _I, _I), _I),
    "mem_attention_long_bwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _F, _I, _P), _I),
    "mem_attention_long_bwd_max_d": ((), _I),
    "mem_attention_long_bwd_scalar_smem": ((_I, _I), ctypes.c_longlong),
    "mem_attention_long_bwd_ws_stride": ((_I, _I), _I),
    "mem_attention_long_bwd_uses_mma": ((_P, _P, _P, _P, _P, _P, _P, _I, _I), _I),
    "mem_attention_long_fwd_bhnd": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P), _I),
    "mem_attention_bwd_whole_bhnd": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _F, _I, _P), _I),
    "mem_attention_bwd_blocked_bhnd": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _F, _I, _P), _I),
    "mem_exp_voxelize_base": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    "mem_exp_voxelize_fused_onehot": ((_P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    "mem_exp_voxelize2_fused_i8": ((_P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    "mem_exp_voxelize2_tiled": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), _I),
    "mem_exp_voxelize2_tiled_i8": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), _I),
    "mem_attention_bwd_pair": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _F, _I, _P), _I),
    "mem_cuda_error_string": ((_I,), ctypes.c_char_p),
    "mem_cuda_set_device": ((_I,), _I),
}

_lock = threading.Lock()
_lib = None
_thread = threading.local()   # the device this thread's context was bound to


def find_nvcc() -> str | None:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _check_device() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; none is available")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); this device "
            f"({torch.cuda.get_device_name()}) has capability {cap}")


def build() -> Path:
    """Compile csrc/*.cu (in parallel) and link them, unless the cached
    library for these sources exists; returns its path."""
    tag = _digest()
    lib_path = BUILD_DIR / f"libmem_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH "
                           "and /usr/local/cuda/bin); the kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sources()
    objs = [BUILD_DIR / f"{p.stem}_{tag}.{os.getpid()}.o" for p in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)] for p, o in zip(srcs, objs)]
    with ThreadPoolExecutor(len(cmds)) as pool:   # the threads only wait on nvcc
        procs = list(pool.map(lambda c: subprocess.run(c, capture_output=True, text=True), cmds))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    failed = [p for p in procs if p.returncode != 0]
    if not failed:
        cmds.append([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        procs.append(subprocess.run(cmds[-1], capture_output=True, text=True))
        failed = [p for p in procs[-1:] if p.returncode != 0]
    (BUILD_DIR / f"build_{tag}.log").write_text("".join(
        " ".join(c) + "\n" + p.stdout + p.stderr for c, p in zip(cmds, procs)))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0].returncode}):\n"
                           f"{failed[0].stderr[-4000:]}")
    os.replace(tmp, lib_path)   # atomic: a concurrent loader never sees half a file
    return lib_path


def build_log() -> str:
    """The nvcc/ptxas output of the build of the current sources, if any."""
    p = BUILD_DIR / f"build_{_digest()}.log"
    return p.read_text() if p.exists() else ""


def library(device=None) -> ctypes.CDLL:
    """The bound kernel library; checks the device and builds on first call.

    A wrapper that launches passes its operands' ``device`` (a CUDA
    ``torch.device`` or index): on each thread, once per device, that
    device's context is made current for the library's own (static) CUDA
    runtime, whose launches otherwise go to the context it last bound on
    that thread, or to device 0's. PyTorch may not have touched the card on
    that thread yet (a fresh thread; autograd's device thread)."""
    global _lib
    with _lock:
        if _lib is None:
            _check_device()
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    if device is not None:
        index = device if isinstance(device, int) else device.index
        if index is None:
            import torch

            index = torch.cuda.current_device()
        if getattr(_thread, "device", None) != index:
            rc = _lib.mem_cuda_set_device(index)
            if rc != 0:
                raise RuntimeError(f"cudaSetDevice({index}): CUDA error {rc} "
                                   f"({_lib.mem_cuda_error_string(rc).decode()})")
            _thread.device = index
    return _lib


def check(name: str, rc: int) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        msg = library().mem_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
