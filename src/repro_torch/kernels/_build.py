"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source ``csrc/<name>.cu`` compiles, at first use, into
``build/lib<name>-<hash>.so`` at the root of the checkout; the hash covers the
source, the shared header and the flags, so an edit rebuilds and an unchanged
tree reuses the library.  ``build_all`` starts one ``nvcc`` per source, all
together.  The libraries export a plain C interface: pointers and the CUDA
stream pass as ``c_void_p``, sizes as ``c_int``, and every entry returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("token_shuffle", "grouped_gemm", "fused_ffn", "fused_ffn_bwd",
           "flash_attention")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132  # streaming multiprocessors of an H100 SXM: the grids the host plans fill

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built with the CUDA toolkit (set CUDA_HOME)")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns {name: path}.  The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    BUILD.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library ``name`` with ``argtypes`` set from ``signatures``
    ({c function: [ctypes types]}); every function returns a C int."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def all_meta(*tensors) -> bool:
    """Whether every tensor given (None skipped) is on the meta device: the
    dry run's shapes, which a wrapper's meta branch takes (allocating what
    its kernel allocates, computing nothing).  A mix of devices is not."""
    ts = [t for t in tensors if t is not None]
    return bool(ts) and all(t.device.type == "meta" for t in ts)


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Check what a kernel takes: CUDA, contiguous, one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")


def dtype_code(what: str, t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise ValueError(f"{what}: dtype {t.dtype} not supported "
                         f"(float32 or bfloat16)") from None
