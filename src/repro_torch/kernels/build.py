"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use by ``nvcc`` into ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), then loaded with ``ctypes``.  No
PyTorch headers are included, so a build takes seconds.  A source may
add flags of its own (`EXTRA_FLAGS`) and include headers from
``csrc/`` (``#include "x.cuh"``).  The library file name carries a
digest of the source, every header it includes from ``csrc/`` and its
flags, so an edited source or header is rebuilt and a stale library is
never loaded.

``build()`` starts one ``nvcc`` per source, all at once, and waits for
them together.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS: Tuple[str, ...] = ("rmsnorm", "flash_attention",
                            "flash_attention_bwd", "moe_dispatch",
                            "ssm_scan", "ssm_scan_bwd", "simt_machine")
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The SIMT machine must reproduce the JAX machine's floats bit for bit:
# no fast math and no contracted multiply-adds
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {
    "simt_machine": ("-ftz=true", "-prec-div=true", "-prec-sqrt=true",
                     "-fmad=false")}

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header it includes, directly or
    through another header, from ``csrc/`` (quoted includes)."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.is_file():
                todo.append(dep)
    return found


def lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library in parallel; returns each kernel's
    ``ptxas -v`` report (empty for a library that was already built).
    Raises on the first failed compile, after all have ended."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    reports: Dict[str, str] = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            reports[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def function(name: str, symbol: str, argtypes: Sequence[object]):
    """The C function `symbol` of kernel library `name`, typed: every
    pointer and the stream are ``c_void_p`` (a bare Python int would be
    passed as a 32-bit int and cut).  Returns ``cudaGetLastError()``."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

