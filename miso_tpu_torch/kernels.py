"""Build and bind the port's CUDA kernels.

At first use, ``nvcc`` compiles each ``csrc/*.cu`` into an object file --
one ``nvcc`` per source, all started together -- and links them into one
shared library with a plain C interface under ``miso_tpu_torch/build/``;
it rebuilds when a source is newer than the library.  The
library is loaded with ``ctypes``: pointers and the stream go as
``c_void_p`` (a bare int would be cut to 32 bits), scalars as
``c_int``/``c_uint``.  Each C entry point returns ``cudaGetLastError()``
after its launch.  Nothing here includes PyTorch's headers, so a build
takes seconds, not minutes.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libmiso_kernels.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]
# per-source flags: the marginal and multinomial kernels must round every
# product and sum on their own, as their plain versions do (see their
# headers)
SOURCE_FLAGS = {"marginal_kernel.cu": ["-fmad=false"],
                "multinomial_kernel.cu": ["-fmad=false"]}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas registers / spills) and took
BUILD_INFO = {"seconds": None, "log": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.isfile(cuda):
        return cuda
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _run_all(cmds):
    """Start every command at once; wait for all.  Returns the combined
    output; raises with the first failure's command and output."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    logs, failed = [], None
    for cmd, proc in procs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = "nvcc failed (%d):\n%s\n%s" % (
                proc.returncode, " ".join(cmd), out)
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


def build() -> str:
    """Compile csrc/*.cu into LIB_PATH unless it is newer than every
    source.  Returns the library path; raises if nvcc fails."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not sources:
        raise RuntimeError("no CUDA sources under %s" % CSRC)
    newest = max(os.path.getmtime(s) for s in sources)
    if os.path.isfile(LIB_PATH) and os.path.getmtime(LIB_PATH) >= newest:
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [os.path.join(BUILD_DIR, "%s.%d.o" % (
        os.path.basename(s)[:-3], tag)) for s in sources]
    tmp = "%s.%d.tmp" % (LIB_PATH, tag)
    t0 = time.time()
    try:
        log = _run_all([
            [nvcc] + NVCC_FLAGS + SOURCE_FLAGS.get(os.path.basename(s), [])
            + ["-c", s, "-o", o] for s, o in zip(sources, objs)])
        log += _run_all([[nvcc] + ARCH + ["-shared"] + objs + ["-o", tmp]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        BUILD_INFO["seconds"] = time.time() - t0
    BUILD_INFO["log"] = log
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of the kernel library on ``lib``."""
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.miso_reassign.restype = ci
    lib.miso_reassign.argtypes = (
        [vp] * 14          # 9 inputs (start may be null), 5 outputs
        + [ci] * 8         # E, R, I, K, iters, burn_in, lag, rrec
        + [cu, cu]         # seed words
        + [ci] * 4         # fixed_u, T, lanes per block, home
        + [ctypes.c_longlong, vp])   # shared bytes, stream
    lib.miso_marginal.restype = ci
    lib.miso_marginal.argtypes = (
        [vp] * 10          # 6 inputs (start may be null), 4 outputs
        + [ci] * 8         # E, C, I, K, iters, burn_in, lag, rrec
        + [cu, cu]         # seed words
        + [ci] * 3         # fixed_u, T, lanes per block
        + [vp])            # stream
    lib.miso_multinomial.restype = ci
    lib.miso_multinomial.argtypes = (
        [vp] * 16          # 10 inputs (start may be null), 5 outputs,
                           # scratch (null at the register widths)
        + [ci] * 8         # E, C, I, K, iters, burn_in, lag, rrec
        + [cu, cu]         # seed words
        + [ci] * 3         # fixed_u, T, lanes per block
        + [vp])            # stream
    lib.miso_cuda_error_string.restype = ctypes.c_char_p
    lib.miso_cuda_error_string.argtypes = [ci]
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(build()))
        return _LIB


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.miso_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError("%s: CUDA error %d (%s)" % (what, rc, msg))
