"""The profiler window: a ``torch.profiler`` capture aligned with spans.

The port's counterpart of ``veles_tpu/observe/profile.py:20-66``.
``--profile DIR`` (the CLI) wraps a run in :func:`profile_window`, which
records CPU and CUDA activity with ``torch.profiler.profile`` and
writes a Chrome trace into ``DIR``. For the window the tracer is on and
``annotate_device`` is set, so every span also opens a
``record_function`` range (and an NVTX range on the card) of its name:
``paged.dispatch`` on the host stands over the kernels it launched.
The profiler records every thread (``profile_all_threads``, where the
installed torch has it): the serving driver's spans run on its own
thread.

A profiler that fails to start is logged and the run goes on without a
capture, as in the JAX package: a capture is not a result.
"""

import contextlib
import logging
import os
import time


def _all_threads():
    """The profiler's config recording every thread, or None (the
    calling thread only) where the installed torch lacks the option."""
    import torch

    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        logging.getLogger("observe.profile").warning(
            "this torch profiles the calling thread only: spans of "
            "other threads are left out of the capture")
        return None


@contextlib.contextmanager
def profile_window(profile_dir, annotate=True):
    """Capture the enclosed window into
    ``<profile_dir>/trace-<pid>-<stamp>.json`` (open it in
    ``ui.perfetto.dev``); yields that path, or None when no capture
    runs. ``annotate=True`` turns on span-named ranges and enables the
    tracer for the window, restoring both after. CUDA activity is
    recorded when the process can see a card. ``profile_dir`` of
    None/"" makes this a no-op."""
    if not profile_dir:
        yield None
        return
    import torch

    from veles_tpu_torch.observe.tracing import get_tracer

    tracer = get_tracer()
    saved = tracer.annotate_device
    saved_enabled = tracer.enabled
    log = logging.getLogger("observe.profile")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(profile_dir, "trace-%d-%s.json" % (
        os.getpid(), time.strftime("%Y%m%d-%H%M%S")))
    try:
        os.makedirs(profile_dir, exist_ok=True)
        profiler = torch.profiler.profile(
            activities=activities, experimental_config=_all_threads())
        profiler.__enter__()
    except Exception:   # noqa: BLE001 - the run goes on uncaptured
        log.exception("torch profiler unavailable; continuing without "
                      "a capture")
        yield None
        return
    if annotate:
        tracer.annotate_device = True
        tracer.enabled = True
    try:
        yield path
    finally:
        tracer.annotate_device = saved
        tracer.enabled = saved_enabled
        try:
            profiler.__exit__(None, None, None)
            profiler.export_chrome_trace(path)
            log.info("profile written to %s", path)
        except Exception:   # noqa: BLE001
            log.exception("torch profiler capture failed to finalize; "
                          "the run itself is unaffected")
