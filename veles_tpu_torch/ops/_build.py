"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source is one shared library with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into ``veles_tpu_torch/_build/`` on first use and
loaded with ``ctypes``. The library name carries a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
rebuilds. Nothing here runs at import time, and the CPU path never calls
it. A failed build raises. Each build (with its wall seconds) and each
library load is reported to the device-truth plane's tracker
(``observe/xla_stats.py``), labelled by the kernel's source: the port's
compile events.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from veles_tpu_torch.observe.xla_stats import get_compile_tracker

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: every kernel source of the port, by stem
KERNELS = ("int8_matmul", "paged_attention", "paged_attention_int8",
           "cache_attend_int8", "gemm", "dense_epilogue", "flash_attention",
           "flash_attention_bwd")

_lock = threading.Lock()
_libs = {}
_functions = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels are compiled from ops/csrc on first use")
    return path


def library_path(name):
    """Where the library built from ``csrc/<name>.cu`` lives. The name's
    hash covers the source, every shared header in ``csrc/`` and the
    flags."""
    digest = hashlib.sha256((CSRC / (name + ".cu")).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest = digest.hexdigest()
    return BUILD_DIR / ("%s-%s.so" % (name, digest[:16]))


def build(names=KERNELS):
    """Compile every named kernel whose library is missing, one
    ``nvcc`` process per source, all started together. Returns
    ``{name: compiler output}`` for the sources it compiled (``-Xptxas
    -v`` prints each kernel's registers and shared memory); raises
    RuntimeError naming every source that failed."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        running = []
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name("%s.tmp%d" % (out.name, os.getpid()))
            log = open(BUILD_DIR / (name + ".log"), "w+")
            started = time.perf_counter()
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / (name + ".cu"))],
                stdout=log, stderr=subprocess.STDOUT)
            running.append((name, out, tmp, log, proc, started))
        # each source's build seconds run from its start to its exit,
        # polled, since the sources finish in any order
        ended = {}
        while len(ended) < len(running):
            for name, _, _, _, proc, started in running:
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.perf_counter() - started
            if len(ended) < len(running):
                time.sleep(0.05)
        logs, failed = {}, []
        for name, out, tmp, log, proc, _ in running:
            code = proc.wait()
            log.seek(0)
            logs[name] = log.read()
            log.close()
            if code:
                failed.append("%s.cu (exit %d):\n%s"
                              % (name, code, logs[name]))
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
                get_compile_tracker().record_compile(name + ".cu",
                                                     ended[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return logs


def function(name, symbol, argtypes):
    """The C function ``symbol`` of the library built from
    ``csrc/<name>.cu``, with its ctypes signature set (every function
    returns the ``cudaError_t`` of its launch as an int). Builds the
    library first when it is missing."""
    key = (name, symbol)
    fn = _functions.get(key)
    if fn is not None:
        return fn
    build((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = time.perf_counter()
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            get_compile_tracker().record_hit(
                name + ".cu", time.perf_counter() - started)
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn
