"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into its own shared library
with a plain C interface and loaded with ctypes; no PyTorch headers are
involved, so a build takes seconds. Libraries land in build/kernels/ at
the repository root (git-ignored), named by a hash of source, the
shared headers it includes and flags, and are built on first use. All sources are compiled
in parallel by build().

LAUNCHES counts the kernel launches made by each wrapper:
ops/filters.py:banded_fir, fir_up2_fused_planes (counter fir_up2_fused),
fir_up2_fused_symbols, duc_from_spec_planes (counter duc_from_spec),
ops/ldpc/decode.py:ldpc_minsum (one counter per variant of its kernel:
ldpc_minsum_flooded, ldpc_minsum_flooded_fast, ldpc_minsum_layered,
ldpc_minsum_layered_fast) and ldpc_minsum_packed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "build" / "kernels"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# source stem -> extra nvcc flags
_SOURCES = {
    # banded_fir takes the register-blocked loop from csrc/duc_common.cuh
    "banded_fir": [],
    # the LDPC decoders are bit-exact with the JAX reference: no FMA
    # contraction; both share csrc/ldpc_common.cuh
    "ldpc_minsum": ["--fmad=false"],
    "ldpc_minsum_packed": ["--fmad=false"],
    # the three fused DUC kernels share csrc/duc_common.cuh
    "fir_up2_fused": [],
    "fir_up2_fused_symbols": [],
    "duc_from_spec": [],
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "banded_fir": ("banded_fir", [_P] * 3 + [_I] * 10 + [_P]),
    "ldpc_minsum": ("ldpc_minsum",
                    [_P, _P] + [_I] * 7 + [_F, _F] + [_I] * 5 + [_P] * 5),
    "ldpc_minsum_packed": ("ldpc_minsum_packed",
                           [_P, _P] + [_I] * 7 + [_F, _F] + [_I] * 6
                           + [_P, _I] + [_P] * 4),
    "fir_up2_fused": ("fir_up2_fused", [_P] * 4 + [_I] * 4 + [_P]),
    "fir_up2_fused_symbols": ("fir_up2_fused_symbols",
                              [_P] * 5 + [_I] * 6 + [_P]),
    "duc_from_spec": ("duc_from_spec", [_P] * 8 + [_I] * 9 + [_P]),
}

LAUNCHES = {"banded_fir": 0, "ldpc_minsum_flooded": 0,
            "ldpc_minsum_flooded_fast": 0, "ldpc_minsum_layered": 0,
            "ldpc_minsum_layered_fast": 0, "ldpc_minsum_packed": 0,
            "fir_up2_fused": 0, "fir_up2_fused_symbols": 0,
            "duc_from_spec": 0}
# the H100 SXM the kernels are planned for: streaming multiprocessors, and
# the dynamic shared memory a block may opt in to on sm_90 (227 KB)
H100_SMS = 132
SMEM_OPTIN_BYTES = 232448

BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return path


def _command(stem: str) -> tuple[list[str], pathlib.Path]:
    src = _CSRC / f"{stem}.cu"
    flags = _ARCH + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"] + _SOURCES[stem]
    text = src.read_bytes()
    # only the shared headers this source includes
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh"))
                       if f'#include "{h.name}"'.encode() in text)
    digest = hashlib.sha256(text + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}-{digest}.so"
    return [_nvcc(), *flags, "-o", str(out), str(src)], out


def build(stems=None) -> dict[str, float]:
    """Compile the given sources (default: all) concurrently; return the
    wall seconds per source (0.0 if already built). Raises on failure."""
    stems = list(_SOURCES) if stems is None else list(stems)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    t0 = time.perf_counter()
    for stem in stems:
        cmd, out = _command(stem)
        if out.exists():
            secs[stem] = 0.0
            continue
        # compile to a temporary name so a cut build never looks finished
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd[cmd.index(str(out))] = str(tmp)
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[stem] = time.perf_counter() - t0
        BUILD_LOG[stem] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem}.cu:\n{log}")
        os.replace(tmp, out)
    return secs


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu, built on first use."""
    lib = _LIBS.get(stem)
    if lib is None:
        _, out = _command(stem)
        if not out.exists():
            build([stem])
        lib = ctypes.CDLL(str(out))
        name, argtypes = _SIGNATURES[stem]
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[stem] = lib
    return lib


def check(stem: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{stem} kernel launch failed with CUDA error "
                           f"{rc}")
