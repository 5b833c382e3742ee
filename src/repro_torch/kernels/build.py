"""Build and bind the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into an object file, all sources at once in parallel, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``.  The library lives under ``build/repro_torch/`` at the root of
the checkout, named by a hash of the sources and the headers they include
(``csrc/*.cuh``), so an edited source or header is never served from a
stale build.  The build happens at first use: importing this
module compiles nothing.  ``nvcc``'s own report (``-Xptxas -v``: registers,
shared memory, spills per kernel) is kept in ``build.log`` beside the
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
#: C entry points and their argument types (pointers and the stream as
#: ``c_void_p``, ints as ``c_int`` or ``c_longlong``, floats as
#: ``c_float``); every one returns ``cudaError_t``.
SIGNATURES = {
    # x, sx0, sx1, m, sm0, sm1, wt, occ, wt8, occ8, y, macs, ws, ws_bytes,
    # m_rows, k, nb, splits, splits_m, kind, threshold, pad_x, pad_m, stream
    "event_matmul_pair_launch": [_P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _P,
                                 _P, _P, _L, _I, _I, _I, _I, _I, _I, _F, _I,
                                 _I, _P],
    # a, s, q, s_out, n, theta, bf16, stream
    "sigma_delta_launch": [_P, _P, _P, _P, _L, _F, _I, _P],
    # x, live, out, n_windows, D, window, stream
    "window_cumsum_launch": [_P, _P, _P, _I, _I, _I, _P],
    # q, k, v, o, B, Sq, Skv, H, K, hd, causal, window, softcap, kv_len,
    # scale, stream
    "flash_attn_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _F, _I, _F, _P],
    # pre, ld, x0, y, x_out, T, N, decay, force_active, stream
    "ssm_scan_launch": [_P, _L, _P, _P, _P, _I, _I, _F, _I, _P],
    # x, hi, lo, n, stream
    "tf32_split_launch": [_P, _P, _P, _L, _P],
    # pre, ld_pre, macs, ld_macs, bias, gate, y, msgs, acts, counts,
    # counts64, T, N, code, stream
    "neuron_epilogue_launch": [_P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def sources() -> list[pathlib.Path]:
    """The translation units nvcc compiles."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[pathlib.Path]:
    """The headers the sources include: hashed, not compiled."""
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile (if not already built) and return the shared library path.
    Raises ``RuntimeError`` with nvcc's output if a source fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name} (rc={p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if not failed:
            tmp_lib = pathlib.Path(tmp) / lib.name
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp_lib),
                 *[str(obj) for _, obj, _ in procs]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link (rc={link.returncode})\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
            else:
                os.replace(tmp_lib, lib)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
