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

``load_b3_clocks`` builds a second library, apart: the multinomial kernel
alone with ``-DMISO_B3_CLOCKS``, which adds clock64() stamps between the
phases of a step and a latency probe (see the source's ``ClockSlot``);
``load_b2w_clocks`` a third: the wide kernels' source alone with
``-DMISO_B2W_CLOCKS``, B2w's stamps (``B2wClock``) and a probe of its
barriers.  Only ``chip_smoke.py`` asks for them; ``load`` never builds
them.
"""
from __future__ import annotations

import ctypes
import glob
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libmiso_kernels.so")
CLOCKS_LIB_PATH = os.path.join(BUILD_DIR, "libmiso_b3_clocks.so")
B2W_CLOCKS_LIB_PATH = os.path.join(BUILD_DIR, "libmiso_b2w_clocks.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]
# per-source flags: the marginal, multinomial and wide kernels must round
# every product and sum on their own, as their plain versions do (see
# their headers)
SOURCE_FLAGS = {"marginal_kernel.cu": ["-fmad=false"],
                "multinomial_kernel.cu": ["-fmad=false"],
                "wide_kernel.cu": ["-fmad=false"]}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_CLOCKS_LIB: Optional[ctypes.CDLL] = None
_B2W_CLOCKS_LIB: Optional[ctypes.CDLL] = None
# what the last build of LIB_PATH printed (ptxas registers / spills) and
# took
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


def build(lib_path: str = LIB_PATH, sources=None, defines=(),
          info=BUILD_INFO) -> str:
    """Compile ``sources`` (default csrc/*.cu), each with ``defines`` as
    -D flags, into ``lib_path`` unless it is newer than every source.
    Returns the library path; raises if nvcc fails."""
    if sources is None:
        sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not sources:
        raise RuntimeError("no CUDA sources under %s" % CSRC)
    newest = max(os.path.getmtime(s) for s in sources)
    if os.path.isfile(lib_path) and os.path.getmtime(lib_path) >= newest:
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = "%s.%d" % (os.path.basename(lib_path), os.getpid())
    objs = [os.path.join(BUILD_DIR, "%s.%s.o" % (
        os.path.basename(s)[:-3], tag)) for s in sources]
    tmp = "%s.%d.tmp" % (lib_path, os.getpid())
    flags = ["-D" + d for d in defines]
    t0 = time.time()
    try:
        log = _run_all([
            [nvcc] + NVCC_FLAGS + SOURCE_FLAGS.get(os.path.basename(s), [])
            + flags + ["-c", s, "-o", o] for s, o in zip(sources, objs)])
        log += _run_all([[nvcc] + ARCH + ["-shared"] + objs + ["-o", tmp]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        info["seconds"] = time.time() - t0
    info["log"] = log
    os.replace(tmp, lib_path)
    return lib_path


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
                           # scratch (null: the lane arrays in shared)
        + [ci] * 8         # E, C, I, K, iters, burn_in, lag, rrec
        + [cu, cu]         # seed words
        + [ci] * 3         # fixed_u, T, lanes per block
        + [ctypes.c_longlong, vp])   # shared bytes, stream
    lib.miso_multinomial_lane_floats.restype = ctypes.c_longlong
    lib.miso_multinomial_lane_floats.argtypes = [ci] * 3
    lib.miso_reassign_wide.restype = ci
    lib.miso_reassign_wide.argtypes = (
        [vp] * 21          # 15 inputs (start may be null), 5 outputs,
                           # scratch (null: the lane arrays in shared)
        + [ci] * 10        # E, C, A, R, I, K, iters, burn_in, lag, rrec
        + [cu, cu]         # seed words
        + [ci] * 3         # fixed_u, threads, table rows
        + [ctypes.c_longlong, vp])   # shared bytes, stream
    lib.miso_marginal_wide.restype = ci
    lib.miso_marginal_wide.argtypes = (
        [vp] * 11          # 6 inputs (start may be null), 4 outputs,
                           # scratch
        + [ci] * 8         # E, C, I, K, iters, burn_in, lag, rrec
        + [cu, cu]         # seed words
        + [ci] * 4         # fixed_u, threads, cluster, rows shared
        + [ctypes.c_longlong, vp])   # shared bytes, stream
    lib.miso_wide_lane_floats.restype = ctypes.c_longlong
    lib.miso_wide_lane_floats.argtypes = [ci] * 4
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


CLOCKS_BUILD_INFO = {"seconds": None, "log": ""}


def bind_b3_clocks(lib: ctypes.CDLL, errors: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the step-breakdown library's C interface on ``lib``: the
    multinomial kernel's entry point, the reader of its sums and the
    latency probe; ``errors`` lends the error strings."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.miso_multinomial.restype = ci
    lib.miso_multinomial.argtypes = errors.miso_multinomial.argtypes
    lib.miso_multinomial_clocks.restype = ci
    lib.miso_multinomial_clocks.argtypes = [vp]
    if hasattr(lib, "miso_multinomial_latencies"):
        lib.miso_multinomial_latencies.restype = ci
        lib.miso_multinomial_latencies.argtypes = [vp, ci, vp]
    lib.miso_cuda_error_string = errors.miso_cuda_error_string
    return lib


def load_b3_clocks() -> ctypes.CDLL:
    """The multinomial kernel built with its step-breakdown stamps
    (-DMISO_B3_CLOCKS) into CLOCKS_LIB_PATH, a library of its own, at
    first use; never the production library.  For ``chip_smoke.py``'s
    breakdown only."""
    global _CLOCKS_LIB
    errors = load()
    path = build(CLOCKS_LIB_PATH,
                 [os.path.join(CSRC, "multinomial_kernel.cu")],
                 ["MISO_B3_CLOCKS"], CLOCKS_BUILD_INFO)
    with _LOCK:
        if _CLOCKS_LIB is None:
            _CLOCKS_LIB = bind_b3_clocks(ctypes.CDLL(path), errors)
        return _CLOCKS_LIB


B2W_CLOCKS_BUILD_INFO = {"seconds": None, "log": ""}


def bind_b2w_clocks(lib: ctypes.CDLL, errors: ctypes.CDLL) -> ctypes.CDLL:
    """Declare B2w's step-breakdown library's C interface on ``lib``: its
    entry point, the reader of its sums and (built by nvcc) the barrier
    probe; ``errors`` lends the error strings."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.miso_marginal_wide.restype = ci
    lib.miso_marginal_wide.argtypes = errors.miso_marginal_wide.argtypes
    lib.miso_marginal_wide_clocks.restype = ci
    lib.miso_marginal_wide_clocks.argtypes = [vp]
    if hasattr(lib, "miso_wide_latencies"):
        lib.miso_wide_latencies.restype = ci
        lib.miso_wide_latencies.argtypes = [vp, ci]
    lib.miso_cuda_error_string = errors.miso_cuda_error_string
    return lib


def load_b2w_clocks() -> ctypes.CDLL:
    """The wide kernels built with B2w's step-breakdown stamps
    (-DMISO_B2W_CLOCKS) into B2W_CLOCKS_LIB_PATH, a library of its own,
    at first use; never the production library.  For ``chip_smoke.py``'s
    breakdown only."""
    global _B2W_CLOCKS_LIB
    errors = load()
    path = build(B2W_CLOCKS_LIB_PATH, [os.path.join(CSRC, "wide_kernel.cu")],
                 ["MISO_B2W_CLOCKS"], B2W_CLOCKS_BUILD_INFO)
    with _LOCK:
        if _B2W_CLOCKS_LIB is None:
            _B2W_CLOCKS_LIB = bind_b2w_clocks(ctypes.CDLL(path), errors)
        return _B2W_CLOCKS_LIB


def source_enum(enum: str, source: str = "multinomial_kernel.cu"):
    """The names of C enum ``enum`` in csrc/``source``, in order, the
    last (its count) left out: the slots of the step-breakdown arrays."""
    with open(os.path.join(CSRC, source)) as f:
        body = re.search(r"enum %s \{(.*?)\};" % enum, f.read(),
                         re.S).group(1)
    names = [re.sub(r"//.*", "", ln).strip().rstrip(",")
             for ln in body.splitlines()]
    names = [n for part in names for n in part.split(",") if n.strip()]
    return [n.strip() for n in names][:-1]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.miso_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError("%s: CUDA error %d (%s)" % (what, rc, msg))
