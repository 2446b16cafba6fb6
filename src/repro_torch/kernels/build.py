"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain
C interface, loaded with ``ctypes``.  The build goes to
``build/repro_torch_kernels/<hash of the sources and flags>/`` under the
repository root at first use, so a fresh checkout builds itself; nothing
is built or imported when this module is imported.  Each C entry point
launches on the stream it is given and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIMS = (16, 32, 64, 128)  # the head dims the attention kernels take

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: every pointer and the stream are c_void_p (a bare int
# would be passed as 32 bits and cut the pointer).
SIGNATURES = {
    "repro_flash_attention_bf16":
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "repro_decode_attention_bf16":
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "repro_paged_decode_attention_bf16":
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "repro_decode_attention_q8":
        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "repro_paged_decode_attention_q8":
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
         _P),
    "repro_wkv6_bf16":
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_wkv6_chunked_bf16":
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_ssm_scan_bf16":
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "repro_ssm_chunked_bf16":
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (one nvcc per file, in parallel) and link the
    library; returns its path.  Idempotent: an existing build of the same
    sources is reused.  ``ptxas.log`` beside the library keeps each
    kernel's register and shared-memory report."""
    out_dir = BUILD_ROOT / source_digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    tmp = out_dir.with_name(f"{out_dir.name}.tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    exe = nvcc()
    procs = []
    for src in _sources():
        obj = tmp / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    objs = [str(tmp / (src.stem + ".o")) for src, _ in procs]
    link = subprocess.run([exe, "-shared", "-o", str(tmp / LIB_NAME), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
    (tmp / "ptxas.log").write_text("\n".join(logs))
    try:
        os.replace(tmp, out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def pointers(name: str, device, tensors: dict, align: int = 1
             ) -> list[int]:
    """Validate kernel operands and return their device pointers.

    ``tensors`` maps an operand name to ``(tensor, dtype)`` or ``(tensor,
    dtype, align)``: each must lie on ``device`` (a CUDA device), have that
    dtype and be contiguous — the kernels compute their own offsets from
    the shapes alone — and start at a multiple of its own ``align`` or
    else the call's (16 where a kernel moves rows with 16-byte copies).
    """
    ptrs = []
    for arg, (t, dtype, *own) in tensors.items():
        at = own[0] if own else align
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % at:
            raise ValueError(f"{name}: {arg} must start at a multiple of "
                             f"{at} bytes")
        ptrs.append(t.data_ptr())
    return ptrs


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
