"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with
``ctypes``.  Nothing is built at import: the first CUDA call of a kernel
builds it (``load``), and ``build_all`` builds several at once, one
``nvcc`` process per source, all started together.  Libraries land in
``build/repro_torch/`` at the repo root (listed in ``.gitignore``), named
by a hash of their source and flags, so an edited source never loads a
stale library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every C entry point, by library
SIGNATURES = {
    "spmm_csr": {
        "spmm_csr_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "hadamard_spmm": {
        "hadamard_spmm_f32": (_P, _P, _P, _P, _P, _P, _I, _F, _P, _I, _I, _I,
                              _I, _P),
    },
    "embedding_bag": {
        "embedding_bag_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "ann_block_scores": {
        "ann_block_scores_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "topk_score": {
        "fused_topk_score_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _L, _I, _I, _I, _I, _I, _I, _P),
        "fused_topk_score_smem": (_I, _I),
    },
}
_RESTYPES = {"fused_topk_score_smem": _L}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels are built from source at "
                           "first use and need the CUDA toolkit")
    return str(path)


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: pathlib.Path,
            out: pathlib.Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent reader sees all or none


def _open(name: str, path: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = _RESTYPES.get(fn, _I)
    lib.repro_error_string.argtypes = [_I]
    lib.repro_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def build_all(names=tuple(SIGNATURES)) -> None:
    """Build every named library that is not built yet, one ``nvcc`` per
    source, all running at once; raise on the first failure."""
    jobs = [(n, *_start(n)) for n in names
            if n not in _loaded and not library_path(n).exists()]
    errors = []
    for n, proc, tmp, out in jobs:
        try:
            _finish(n, proc, tmp, out)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for n in names:
        if n not in _loaded:
            _open(n, library_path(n))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = _loaded[name]
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
