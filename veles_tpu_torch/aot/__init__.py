"""AOT bundles: a serving replica that boots with no ``nvcc``.

The port of ``veles_tpu/aot/``. What a fresh process of the port
compiles is the ``nvcc`` build of each kernel library it launches
(``ops/_build.py``); ``artifact.py`` packs those libraries, with one
manifest row per program the decoder (or the fused tick) dispatches,
into a versioned, sha-addressed bundle; ``loader.py`` gates it against
this process and stages the libraries, so the programs load instead of
building; ``exec_cache.py`` keeps staged libraries on disk behind a
sidecar; ``cli.py`` is ``python -m veles_tpu_torch aot
build|inspect|verify|warm-cache``.
"""

from veles_tpu_torch.aot.artifact import (SCHEMA_VERSION, BundleBuilder,
                                          build_serving_bundle,
                                          capture_tick_programs, read_bundle)
from veles_tpu_torch.aot.loader import (AotCompatError, AotPrograms,
                                        check_compat, install_fused_tick,
                                        load_bundle)

__all__ = ["SCHEMA_VERSION", "BundleBuilder", "build_serving_bundle",
           "capture_tick_programs", "read_bundle", "AotCompatError",
           "AotPrograms", "check_compat", "install_fused_tick",
           "load_bundle"]
