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

An AOT bundle (``aot/``) ships built libraries: :func:`stage` registers
one for a source whose digest it was built from equals the tree's
(:func:`source_digest`), and :func:`build` and :func:`function` then
take it and never run ``nvcc`` for that source. A library whose digest
differs is refused, never loaded.
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
#: source stem -> path of a library an AOT bundle staged (:func:`stage`)
_staged = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels are compiled from ops/csrc on first use")
    return path


def source_digest(name):
    """The sha256 a library of ``csrc/<name>.cu`` is built from: the
    source, every shared header in ``csrc/`` and the flags."""
    digest = hashlib.sha256((CSRC / (name + ".cu")).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()


def library_path(name):
    """Where the library built from ``csrc/<name>.cu`` lives; its name
    carries the head of :func:`source_digest`."""
    return BUILD_DIR / ("%s-%s.so" % (name, source_digest(name)[:16]))


def stage(name, path, digest):
    """Serve ``csrc/<name>.cu`` from the built library at ``path`` (an
    AOT bundle's, ``aot/loader.py``) instead of building it: a later
    :func:`function` loads it and never runs ``nvcc`` for ``name``.
    ``digest`` is the :func:`source_digest` the library was built from;
    one that differs from the tree's raises ValueError and nothing is
    staged. A library already loaded in this process stays."""
    if name not in KERNELS:
        raise ValueError("no kernel source %r in ops/csrc" % (name,))
    current = source_digest(name)
    if digest != current:
        raise ValueError(
            "library for %s.cu refused: built from sources %s..., the "
            "tree's are %s..." % (name, str(digest)[:16], current[:16]))
    with _lock:
        _staged[name] = str(path)


def staged_path(name):
    """The path :func:`stage` registered for ``name``, or None."""
    return _staged.get(name)


def unstage(name=None):
    """Forget the staged library of ``name`` (every one by default); a
    library already loaded stays loaded."""
    with _lock:
        if name is None:
            _staged.clear()
        else:
            _staged.pop(name, None)


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
            if name in _staged:
                continue
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


def load(name):
    """The loaded library of ``csrc/<name>.cu``: the one :func:`stage`
    registered, else the built one (built first when it is missing).
    Each process loads a library once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = time.perf_counter()
            lib = _libs[name] = ctypes.CDLL(
                _staged.get(name) or str(library_path(name)))
            get_compile_tracker().record_hit(
                name + ".cu", time.perf_counter() - started)
    return lib


def function(name, symbol, argtypes):
    """The C function ``symbol`` of the library built from
    ``csrc/<name>.cu`` (:func:`load`), with its ctypes signature set
    (every function returns the ``cudaError_t`` of its launch as an
    int)."""
    key = (name, symbol)
    fn = _functions.get(key)
    if fn is not None:
        return fn
    lib = load(name)
    with _lock:
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn
