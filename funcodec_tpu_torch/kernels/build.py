"""Build the port's CUDA sources with nvcc and bind them with ctypes.

At first use, every ``csrc/*.cu`` is compiled for Hopper (sm_90a), one
``nvcc`` per source, all started together, and the objects are linked into
one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c csrc/<name>.cu -o <name>.o          # each source, in parallel
    nvcc -shared -o build/torch_kernels/libfuncodec_kernels-<hash>.so *.o

The library name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads from the cache. The build
directory sits beside the package (``build/`` at the repository root) and is
git-ignored. ptxas' register, shared-memory and spill report of every source is kept
in a ``.log`` file next to the library (``build_report()``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

from funcodec_tpu_torch.utils.profiling import span

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
LIB_NAME = "funcodec_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (restype, argtypes) of every extern "C" entry of csrc/*.cu; pointers and
# the stream pass as c_void_p, so ctypes never cuts them to 32 bits.
SIGNATURES = {
    "funcodec_cuda_error_string": (ctypes.c_char_p, [_I]),
    "rvq_encode_launch": (_I, [_P] * 6 + [_I] * 4 + [_P]),
    "rvq_encode_smem_bytes": (_I, []),
    "conv1d_s1_launch": (_I, [_P] * 4 + [_I] * 9 + [_P]),
    "conv1d_s1_regime": (_I, [_I] * 5),
    "conv1d_s1_chunk": (_I, [_I] * 5),
    "conv1d_s1_out_tile": (_I, [_I] * 5),
    "conv1d_s1_smem_bytes": (_I, [_I] * 5),
    "conv1d_s1_blocks_per_sm": (_I, [_I] * 5),
    "resblock_tgn_launch": (_I, [_I] + [_P] * 10 + [_I] * 9 + [_P]),
    "resblock_tgn_kind": (_I, [_I] * 5),
    "resblock_tgn_blocks_per_sm": (_I, [_I] * 6),
    "resblock_tgn_tile": (_I, [_I] * 5),
    "resblock_tgn_smem_bytes": (_I, [_I] * 5),
    "resblock_tgn_finalize_launch": (_I, [_P, _I, _P] + [_I] * 4 + [_P, _P, _I, _I] * 2 + [_P]),
    "tgn_norm_launch": (_I, [_P, _P, _P, _I, _P, _P] + [_I] * 7 + [_P]),
    "convtr2d_launch": (_I, [_P] * 4 + [_I] * 8 + [_P]),
    "scale_copy_launch": (_I, [_P, _P, _I, _L] + [_I] * 4 + [_P]),
    "dma_copy_launch": (_I, [_P, _P, _L] + [_I] * 3 + [_P]),
    "dma_copy_smem_bytes": (_I, [_I] * 2),
}

_lib: Optional[ctypes.CDLL] = None
_report: Dict[str, object] = {}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); nvcc builds the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{LIB_NAME}-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        _report.update(path=str(out), seconds=0.0, cached=True,
                       ptxas=log.read_text() if log.exists() else "")
        return out
    obj_dir = BUILD_DIR / f"{out.stem}.{os.getpid()}.obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj_dir / f"{src.stem}.o")]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports = []
    for cmd, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{stderr}")
        reports.append(stdout + stderr)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *sorted(str(o) for o in obj_dir.glob("*.o"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    shutil.rmtree(obj_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    ptxas = "".join(reports)
    log.write_text(ptxas)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    _report.update(path=str(out), seconds=seconds, cached=False, ptxas=ptxas)
    return out


def build_report() -> Dict[str, object]:
    """{path, seconds, cached, ptxas} of the last build() in this process."""
    return dict(_report)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _lib
    if _lib is None:
        with span("kernels.load", always=True):  # nvcc unless cached, then dlopen
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if code != 0:
        msg = lib.funcodec_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
