"""Host-side execution pool for the unit graph.

Equivalent of reference ``veles/thread_pool.py:59-606`` (a Twisted
threadpool subclass). The pool runs unit ``run()`` bodies and fleet-mode
callbacks off the control thread; device dispatch is async anyway, so the
pool's job is graph fan-out and services, not compute. Kept from the reference:
pause/resume, worker-exception routing into a failure callback that stops the
workflow (reference ``thread_pool.py:59-68``), and shutdown callbacks (used
there for CUDA context teardown, here for service cleanup).
"""

import queue
import threading
import traceback

from veles_tpu_torch.core.logger import Logger


class ThreadPool(Logger):
    def __init__(self, minthreads=2, maxthreads=8, name="pool"):
        super().__init__(logger_name="ThreadPool(%s)" % name)
        self.maxthreads = maxthreads
        self._queue = queue.Queue()
        self._threads = []
        self._paused = threading.Event()
        self._paused.set()  # set == running
        self._shutdown = False
        self._busy = 0
        self._lock = threading.Lock()
        self.failure_callbacks = []
        self.shutdown_callbacks = []
        for _ in range(minthreads):
            self._spawn()

    def _spawn(self):
        t = threading.Thread(target=self._worker, daemon=True)
        t.start()
        self._threads.append(t)

    def _worker(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            # mark busy immediately on dequeue, before pause-wait or fn, so
            # the spawn heuristic can't undercount while this worker blocks
            fn, args, kwargs = item
            with self._lock:
                self._busy += 1
            self._paused.wait()
            try:
                fn(*args, **kwargs)
            except Exception as exc:  # route into failure callbacks
                tb = traceback.format_exc()
                self.error("Worker exception in %s:\n%s", fn, tb)
                for cb in list(self.failure_callbacks):
                    try:
                        cb(exc, tb)
                    except Exception:
                        self.exception("failure callback raised")
            finally:
                with self._lock:
                    self._busy -= 1

    def call_in_thread(self, fn, *args, **kwargs):
        with self._lock:
            if self._shutdown:
                return
            # spawn when no worker is free for this task: all workers may be
            # blocked (e.g. a nested Workflow.run waiting on its children),
            # in which case queued tasks would otherwise starve
            if (self._busy + self._queue.qsize() >= len(self._threads)
                    and len(self._threads) < self.maxthreads):
                self._spawn()
        self._queue.put((fn, args, kwargs))

    def pause(self):
        """Freeze task consumption (reference pause/resume semantics)."""
        self._paused.clear()

    def resume(self):
        self._paused.set()

    @property
    def paused(self):
        return not self._paused.is_set()

    def shutdown(self):
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        for cb in list(self.shutdown_callbacks):
            try:
                cb()
            except Exception:
                self.exception("shutdown callback raised")
        self._paused.set()
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=2.0)
