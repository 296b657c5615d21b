"""Build and load the port's CUDA kernels.

Each kernel is CUDA C++ in ``emojivoice_tpu_torch/csrc/`` with a plain C
interface.  ``nvcc`` compiles it for ``sm_90a`` into a shared library under
``emojivoice_tpu_torch/build/`` (listed in ``.gitignore``) at first use, and
``ctypes`` loads it.  The library's name carries a hash of its source, the
headers in ``csrc/`` and the flags, so an edited source is rebuilt, never
reused stale.  Nothing is built or loaded at import time: the CPU tests
import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use "
                           "and need the CUDA toolkit (set CUDA_HOME)")
    return found


def build(name: str, defines: tuple = (), src: Path | None = None) -> Path:
    """Compile ``csrc/<name>.cu`` (or `src`, another source built under
    `name`) with ``-D`` for each of `defines` into ``build/lib<name>_<hash>.so``
    unless that exact build exists; ``csrc/`` is on the include path.  The
    compiler's output goes to a ``.log`` beside it."""
    src = CSRC_DIR / f"{name}.cu" if src is None else Path(src)
    flags = (*NVCC_FLAGS, "-I", str(CSRC_DIR), *(f"-D{d}" for d in defines))
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build_many(names) -> None:
    """Compile several kernels at once, one ``nvcc`` process each: a name, or
    a tuple of ``build``'s arguments."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = [(n,) if isinstance(n, str) else tuple(n) for n in names]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        list(pool.map(lambda job: build(*job), jobs))


def build_log(name: str, defines: tuple = ()) -> str:
    """The compiler output (ptxas register and shared-memory report) of the current build."""
    return build(name, defines).with_suffix(".log").read_text()


def _bind_k1(lib: ctypes.CDLL, mode: str, reach: bool = True) -> ctypes.CDLL:
    """Argument types of a K1 library's res-block and one-conv entries (the
    same in both modes) and of its error string.  ``reach=False`` binds a
    source from before the entries took a reach (the probe's earlier
    design)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    resblock, conv = getattr(lib, f"mrf_resblock_{mode}"), getattr(lib, f"mrf_conv_{mode}")
    tail = [p, p] if reach else [p]  # the reach (int32 on the device, or None), the stream
    resblock.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.POINTER(i), i, ctypes.c_float, *tail]
    resblock.restype = i
    conv.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, *tail]
    conv.restype = i
    lib.mrf_error_string.argtypes = [i]
    lib.mrf_error_string.restype = ctypes.c_char_p
    lib.no_reach = (None,) if reach else ()  # what a call without a reach passes there
    return lib


@functools.lru_cache(maxsize=None)
def load_mrf(defines: tuple = ()) -> ctypes.CDLL:
    """K1, the MRF res-block kernel (csrc/mrf.cu), f32 mode, built on first call."""
    return _bind_k1(ctypes.CDLL(str(build("mrf", defines))), "f32")


@functools.lru_cache(maxsize=None)
def load_mrf_bf16(defines: tuple = ()) -> ctypes.CDLL:
    """K1's bf16 mode (csrc/mrf_bf16.cu), built on first call; `defines`
    such as ``K1_BF16_ROUTE=2`` build a variant for measurement."""
    return _bind_k1(ctypes.CDLL(str(build("mrf_bf16", defines))), "bf16")


@functools.lru_cache(maxsize=None)
def load_mas() -> ctypes.CDLL:
    """K2, the monotonic-alignment-search kernel (csrc/mas.cu), built on first call."""
    lib = ctypes.CDLL(str(build("mas")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mas_scratch_words.argtypes = [i, i, i]
    lib.mas_scratch_words.restype = ctypes.c_longlong
    lib.mas_path_f32.argtypes = [p, p, p, p, i, i, i, p]
    lib.mas_path_f32.restype = i
    lib.mas_error_string.argtypes = [i]
    lib.mas_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_moe() -> ctypes.CDLL:
    """K3, the routed-expert kernels (csrc/moe.cu), built on first call: only
    a mixture-of-experts chat decoder asks for it."""
    lib = ctypes.CDLL(str(build("moe")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k3_gemv.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.k3_gemv.restype = i
    lib.k3_grouped.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.k3_grouped.restype = i
    lib.k3_error_string.argtypes = [i]
    lib.k3_error_string.restype = ctypes.c_char_p
    return lib
