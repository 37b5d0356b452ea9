"""Build the CUDA kernel sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources, so an edited kernel is never
served from a stale library.  Libraries are built at first use (or all at
once, in parallel, by ``build_all``) into ``build/repro_torch/`` at the root
of the checkout.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNEL_SOURCES = ("rmsnorm_matmul", "streamed_ffn", "flash_attention",
                  "paged_attention", "block_matmul", "row_norm",
                  "streamed_xent", "moe_experts", "mamba2_scan",
                  "rwkv6_wkv", "stream_converter", "flash_mma",
                  "paged_attention_320", "paged_attention_q320",
                  "streamed_ffn_w8", "paged_attention_64",
                  "paged_attention_80")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's resource report (-Xptxas -v: registers, shared memory, spills)
# per kernel source, from the build that produced the loaded library.
BUILD_LOG: Dict[str, str] = {}
# Seconds from the start of a ``build_all`` to the end of each source's
# nvcc: the longest source bounds the build.
BUILD_SECONDS: Dict[str, float] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in sorted([CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _tmp_path(out: Path) -> Path:
    return out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")


def _start(name: str, nvcc: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp_path(out)
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    out = _lib_path(name)
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    tmp = _tmp_path(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> List[str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together (each waited on by a thread of its own, which times it);
    returns the names that were built."""
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = {n: p for n in names if (p := _start(n, nvcc)) is not None}
    errors: List[str] = []

    def wait(name: str, proc: subprocess.Popen) -> None:
        try:
            _finish(name, proc)
        except RuntimeError as e:
            errors.append(str(e))
        BUILD_SECONDS[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=wait, args=item)
               for item in procs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return list(procs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def declare(lib: ctypes.CDLL, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """Look up a C entry point and declare its signature: every entry
    point returns ``cudaGetLastError()`` as an int."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
