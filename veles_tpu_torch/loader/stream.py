"""Streaming ingestion loader.

The port of ``veles_tpu/loader/stream.py``: the served minibatch and
its mask are torch tensors on the loader's device (the workflow's).

Re-design of reference ``veles/zmq_loader.py:47-74``
(ZeroMQLoader): external producers push work items into the training
process over the network; the loader serves them as TEST minibatches as
they arrive. The ZeroMQ PULL socket becomes an asyncio TCP listener
speaking the fleet wire protocol — length-prefixed pickled frames behind
the same shared-secret HMAC (``fleet/protocol.py``), so untrusted peers
never reach ``pickle.loads``.

Producer side: :class:`StreamFeeder` connects and ``push()``es numpy
arrays (optionally in batches).
"""

import asyncio
import queue
import threading

import numpy
import torch

from veles_tpu_torch.core.mutable import Bool
from veles_tpu_torch.fleet.protocol import (read_frame, resolve_secret,
                                            write_frame)
from veles_tpu_torch.loader.base import Loader, TEST, register_loader


@register_loader("stream")
class StreamLoader(Loader):
    """Serve minibatches from a network-fed queue (reference
    ``ZeroMQLoader``)."""

    def __init__(self, workflow, **kwargs):
        self.sample_shape = tuple(kwargs.pop("sample_shape", ()))
        self.listen_address = kwargs.pop("listen_address", "127.0.0.1:0")
        self.queue_maxsize = kwargs.pop("queue_maxsize", 1024)
        secret = kwargs.pop("secret", None)
        super().__init__(workflow, **kwargs)
        self.complete = Bool(False)
        self._secret = resolve_secret(workflow, secret)
        self.port = None

    def init_unpickled(self):
        super().init_unpickled()
        self._queue_ = queue.Queue(maxsize=self.queue_maxsize)
        self._loop_ = None
        self._thread_ = None

    # -- ILoader --------------------------------------------------------------
    def load_data(self):
        if not self.sample_shape:
            raise ValueError("%s: set sample_shape=" % self.name)
        self.class_lengths = [self.max_minibatch_size, 0, 0]
        self._start_listener()

    def create_minibatch_data(self):
        mb = self.max_minibatch_size
        self.minibatch_data.reset(numpy.zeros(
            (mb,) + self.sample_shape, numpy.float32))
        self.minibatch_indices.reset(numpy.zeros(mb, numpy.int64))
        self.sample_mask.reset(numpy.zeros(mb, numpy.float32))

    def fill_minibatch(self, indices, valid):
        raise AssertionError("StreamLoader overrides run()")

    # -- listener -------------------------------------------------------------
    def _start_listener(self):
        host, _, port = self.listen_address.rpartition(":")
        ready = threading.Event()

        def run_loop():
            self._loop_ = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop_)
            server = self._loop_.run_until_complete(asyncio.start_server(
                self._handle_producer, host or "127.0.0.1", int(port)))
            self.port = server.sockets[0].getsockname()[1]
            ready.set()
            self._loop_.run_forever()
            server.close()

        self._thread_ = threading.Thread(target=run_loop, daemon=True,
                                         name="stream-loader")
        self._thread_.start()
        ready.wait()
        self.info("stream loader listening on port %d", self.port)

    async def _handle_producer(self, reader, writer):
        try:
            while True:
                msg = await read_frame(reader, self._secret)
                mtype = msg.get("type")
                if mtype == "push":
                    # never block the event loop: a full queue answers
                    # "busy" with the accepted count (producer-side
                    # backpressure), instead of stalling acks/end frames
                    accepted = 0
                    busy = False
                    for sample in msg["samples"]:
                        try:
                            self._queue_.put_nowait(
                                numpy.asarray(sample, numpy.float32))
                            accepted += 1
                        except queue.Full:
                            busy = True
                            break
                    await write_frame(
                        writer,
                        {"type": "busy" if busy else "ack",
                         "accepted": accepted}, self._secret)
                elif mtype == "end":
                    try:
                        self._queue_.put_nowait(None)
                    except queue.Full:
                        self.complete.set(True)
                    await write_frame(writer, {"type": "ack"},
                                      self._secret)
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    # -- serving --------------------------------------------------------------
    def run(self):
        """Block for the first queued sample, then drain greedily up to
        one minibatch (latency for the first, throughput for bursts)."""
        mb = self.max_minibatch_size
        batch = numpy.zeros((mb,) + self.sample_shape, numpy.float32)
        first = self._queue_.get()
        if first is None:
            self.complete.set(True)
            return
        batch[0] = first
        n = 1
        while n < mb:
            try:
                sample = self._queue_.get_nowait()
            except queue.Empty:
                break
            if sample is None:
                self.complete.set(True)
                break
            batch[n] = sample
            n += 1
        self.minibatch_class = TEST
        self.minibatch_valid_size = n
        self.minibatch_data.data = torch.from_numpy(batch).to(self.device)
        self.sample_mask.data = torch.from_numpy(
            (numpy.arange(mb) < n).astype(numpy.float32)).to(self.device)
        self.samples_served += n

    def stop(self):
        self.complete.set(True)
        try:  # wake a blocked run(); never block the caller
            self._queue_.put_nowait(None)
        except queue.Full:
            pass
        if self._loop_ is not None and self._loop_.is_running():
            self._loop_.call_soon_threadsafe(self._loop_.stop)


class StreamFeeder:
    """Producer-side client: push numpy samples into a StreamLoader."""

    def __init__(self, address, secret=None, workflow=None):
        host, _, port = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self._secret = resolve_secret(workflow, secret)
        self._loop = asyncio.new_event_loop()
        self._reader, self._writer = self._loop.run_until_complete(
            asyncio.open_connection(self.host, self.port))

    def _call(self, msg):
        async def roundtrip():
            await write_frame(self._writer, msg, self._secret)
            return await read_frame(self._reader, self._secret)

        return self._loop.run_until_complete(roundtrip())

    def push(self, *samples):
        """Returns the loader's reply: ``{"type": "ack"|"busy",
        "accepted": n}`` — on "busy" retry the samples beyond
        ``accepted`` after a pause (consumer-side queue full)."""
        return self._call({"type": "push",
                           "samples": [numpy.asarray(s, numpy.float32)
                                       for s in samples]})

    def end(self):
        try:
            return self._call({"type": "end"})
        finally:
            self._writer.close()
            self._loop.close()
