"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface. The library is cached under ``kernels/_build/<hash>/``, keyed by
a hash of the sources and flags, so an edited source always rebuilds; the
directory is listed in ``.gitignore``. Only the sources in this package are
built. A missing ``nvcc`` or a failed build raises: a CUDA tensor never falls
back to the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argtypes (each returns a cudaError_t as int)
SIGNATURES = {
    # q, k, v, o, lse (null without), B, Sq, Skv, H, KVH, Dh, dtype, causal,
    # window, softcap, scale, stream
    "repro_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _F, _F, _P),
    # q, k_cache, v_cache, lengths, k_new, v_new (null in committed mode),
    # o, partials, part_out (null but in partial mode), B, S, H, KVH, Dh,
    # dtype, lengths dtype, n_splits, window, start, cache batch stride,
    # cache row stride, softcap, scale, stream
    "repro_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _I, _L, _L, _F,
                               _F, _P),
    # gathered partials (R, B*H, Dh + 2) fp32, o, R, B*H, Dh, dtype, stream
    "repro_decode_merge": (_P, _P, _I, _I, _I, _I, _P),
    # logits, weights, ids, slot_of, token_of_slot, tk_of_slot (the three
    # maps null for gating alone), aux, partial, ticket, T, E, k, groups,
    # ctas, cap, stream
    "repro_moe_route": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _P),
    # r, k, v, w, u, s0, out, sT, scratch, B, T, H, K, chunk, dtype, stream
    "repro_rwkv6_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _P),
    # x, dt, A, Bm, Cm, D, h0, y, hT, B, T, Din, N, Bm/Cm batch stride,
    # Bm/Cm time stride, dtype, stream
    "repro_ssm_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _L, _L, _I, _P),
}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _source_hash() / "librepro_kernels.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link one ``.so``;
    returns its path. A cached library for the same sources is reused."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir = lib.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out_dir / f".{lib.name}.{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelBuildError(f"link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's ``argtypes`` declared (pointers and the stream as c_void_p)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def timed_load() -> tuple[ctypes.CDLL, float, str]:
    """Load the library, returning it with the seconds the build and load
    took and the compiler's log (registers, shared memory, spills)."""
    t0 = time.perf_counter()
    lib = load()
    secs = time.perf_counter() - t0
    log_path = library_path().parent / "build.log"
    return lib, secs, (log_path.read_text() if log_path.exists() else "")


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
