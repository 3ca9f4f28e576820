"""Python binding for the native inference runtime (ctypes).

The port of ``veles_tpu/inference.py``. The C++ runtime under ``native/``
(the libVeles role) runs an exported workflow package on the CPU for
embedded and production serving::

    rt = NativeWorkflow("model.tar")
    probs = rt.run(batch_ndarray)

``build_native()`` compiles ``native/src/*.cc`` with ``g++ -O2 -std=c++17
-shared -fPIC -pthread -Inative/include`` into
``veles_tpu_torch/_build/native/libveles_rt.so`` on first use, without
cmake (the card's machine may lack it), and rebuilds it when a source or
header is newer than the library. ``native/`` itself is only read.
"""

import ctypes
import glob
import os
import subprocess
import threading

import numpy

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "native")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build", "native")
LIB_PATH = os.path.join(BUILD_DIR, "libveles_rt.so")

_build_lock = threading.Lock()


def _sources():
    return sorted(glob.glob(os.path.join(NATIVE_DIR, "src", "*.cc")))


def build_native():
    """Compile the native runtime if the library is missing or older than
    any source or header; returns the library path. Raises
    ``subprocess.CalledProcessError`` (with g++'s output) on a failed
    build."""
    with _build_lock:
        inputs = _sources() + glob.glob(
            os.path.join(NATIVE_DIR, "include", "veles_rt", "*"))
        if not inputs:
            raise FileNotFoundError("no native sources under %s"
                                    % NATIVE_DIR)
        if os.path.exists(LIB_PATH):
            newest = max(os.path.getmtime(p) for p in inputs)
            if os.path.getmtime(LIB_PATH) >= newest:
                return LIB_PATH
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build under a private name, then rename: a concurrent loader
        # never maps a half-written library
        tmp = "%s.tmp%d" % (LIB_PATH, os.getpid())
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-I" + os.path.join(NATIVE_DIR, "include"), "-o", tmp]
            + _sources(), check=True, capture_output=True)
        os.replace(tmp, LIB_PATH)
        return LIB_PATH


_lib = None


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native())
        lib.veles_rt_load.restype = ctypes.c_void_p
        lib.veles_rt_load.argtypes = [ctypes.c_char_p]
        lib.veles_rt_last_error.restype = ctypes.c_char_p
        lib.veles_rt_input_size.restype = ctypes.c_longlong
        lib.veles_rt_input_size.argtypes = [ctypes.c_void_p]
        lib.veles_rt_output_size.restype = ctypes.c_longlong
        lib.veles_rt_output_size.argtypes = [ctypes.c_void_p]
        lib.veles_rt_unit_count.restype = ctypes.c_int
        lib.veles_rt_unit_count.argtypes = [ctypes.c_void_p]
        lib.veles_rt_run.restype = ctypes.c_int
        lib.veles_rt_run.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.veles_rt_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeWorkflow:
    """A loaded inference package (reference ``WorkflowLoader::Load`` →
    ``Workflow::Initialize/Run``).

    ``max_batch`` is the admission guard: a batch outside [1, max_batch]
    raises ``ValueError`` instead of asking the runtime for an arbitrarily
    large activation buffer. :meth:`probe` is the readiness check: one
    real one-sample inference."""

    def __init__(self, package_path, max_batch=4096):
        lib = _load_lib()
        self._lib = lib
        self.max_batch = int(max_batch)
        self._handle = lib.veles_rt_load(
            os.fsencode(os.path.abspath(package_path)))
        if not self._handle:
            raise RuntimeError(
                "native load failed: %s"
                % lib.veles_rt_last_error().decode(errors="replace"))
        self.input_size = lib.veles_rt_input_size(self._handle)
        self.output_size = lib.veles_rt_output_size(self._handle)
        self.unit_count = lib.veles_rt_unit_count(self._handle)

    def probe(self):
        """True when the loaded package runs: one zero-sample inference
        end to end, with finite outputs."""
        try:
            out = self.run(numpy.zeros((1, self.input_size),
                                       numpy.float32))
        except (RuntimeError, ValueError):
            return False
        return bool(numpy.all(numpy.isfinite(out)))

    def run(self, batch):
        """Run inference on a (batch, ...) float input; returns (batch,
        output_size) float32."""
        batch = numpy.ascontiguousarray(batch, numpy.float32)
        n = batch.shape[0]
        if not 1 <= n <= self.max_batch:
            raise ValueError("batch size %d outside [1, max_batch=%d]"
                             % (n, self.max_batch))
        flat = batch.reshape(n, -1)
        if flat.shape[1] != self.input_size:
            raise ValueError("input has %d features, package wants %d"
                             % (flat.shape[1], self.input_size))
        out = numpy.empty((n, self.output_size), numpy.float32)
        rc = self._lib.veles_rt_run(
            self._handle,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError(
                "native run failed: %s"
                % self._lib.veles_rt_last_error().decode(errors="replace"))
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.veles_rt_free(self._handle)
            self._handle = None
