"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC

The library lands in ``build/repro_torch/`` at the repository root, named by
a hash of the sources and flags, so an edit rebuilds and an unchanged tree
loads what is there. A failed build raises with the compiler's output; there
are no prebuilt binaries and no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (every one returns a cudaError_t as int)
_SIGNATURES = {
    "g4r_seg_aggr_f32": (_P, _P, _P, _LL, _I, _I, _LL, _LL, _I, _P),
    "g4r_seg_aggr_bwd_f32": (_P, _P, _P, _LL, _I, _I, _LL, _I, _P),
    "g4r_inbatch_rows_f32": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    "g4r_inbatch_attrs": (_I, _P),
    "g4r_row_adagrad_f32": (_P, _P, _P, _P, _LL, _LL, _I, _F, _F, _P),
    "g4r_topk_f32": (_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "g4r_topk_attrs": (_I, _I, _P),
    "g4r_window_pairs_i32": (_P, _P, _P, _P, _LL, _I, _I, _P),
    "g4r_ivf_list_topk_i8": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _P),
    "g4r_flash_attn_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, *(_LL,) * 12, _F, _I,
                           _I, _P),
    "g4r_flash_wgmma_probe": (_P, _P, _P, _P, _P, _P),
    "g4r_flash_attn_attrs": (_I, _I, _P),
}


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from source at first use"
    )


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` (one nvcc each, in parallel) and link the
    shared library; returns its path. A no-op when it is already built."""
    out = BUILD_DIR / f"libg4r_kernels_{source_hash()}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        objs, errors = [], []
        for cmd, obj, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"$ {' '.join(cmd)}\n{log}")
            elif verbose and log:
                print(log, end="")
            objs.append(str(obj))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / out.name
        link = [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp_so)]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(link)}\n{res.stdout}")
        os.replace(tmp_so, out)  # atomic: a concurrent build sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.g4r_error_string.argtypes = [_I]
            lib.g4r_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = library().g4r_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
