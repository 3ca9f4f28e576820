"""The fleet x pod composition: a fleet slave whose tick spans a mesh of
several ranks.

The JAX package has no counterpart of this module and needs none: its pod
slave is one SPMD process over several devices (``veles_tpu/launcher.py:
105-140``, ``veles_tpu/models/standard.py:124-208``), whose fused step
merges the gradients by ``psum``. The port's mesh is a ``torch.distributed``
world, one process per device (``parallel/mesh.py``), so a pod slave is a
world of ranks: rank 0 speaks the fleet wire (``fleet/client.Client``) and
every other rank runs a :class:`Follower` that applies what rank 0 applies,
in the order rank 0 applies it, and steps the same fused tick. The tick's
reduces merge the gradients, the loss, ``n_err`` and the confusion matrix
over the world (``parallel/fused.build_tick``), so every rank applies the
same update and rank 0's update carries the whole minibatch's numbers.

Rank 0's :class:`PodLeader` hands each event on over the world's group,
pickled and broadcast from rank 0: the handshake's initial data (whose
application also resets the tick's residency), each job, each rollback,
each epoch fence and the end of the job stream. A job event carries the
job payload as rank 0 received it: on the data plane the master's weights
ride it (12.79 MB for the wide MLP), on the control plane the minibatch
assignment and the rates. A fence event carries a digest of the weights
rank 0 ships in its fence sync; a follower whose own digest differs has
drifted from rank 0 and fails. Followers open no socket to the master and
ship nothing: rank 0 alone ships updates, metric and history rows and
fence syncs.

No hang: the leader sends the end event on every exit path of the
client's session (stop, no more jobs, a refusal, an error, a spent
reconnect budget). Where rank 0 dies without it (SIGKILL), a follower's
receive fails when the world's connection closes, or at the world's
timeout (``initialize_distributed(timeout=)``, ``root.common.mesh.
timeout``): the follower records the failure, and the launcher raises it,
so the process exits non-zero.
"""

import hashlib
import pickle
import threading
import time

import numpy
import torch

from veles_tpu_torch.core.logger import Logger

#: the events rank 0 hands on, in the order it applies them
INITIAL, JOB, ROLLBACK, FENCE, END = ("initial", "job", "rollback",
                                      "fence", "end")


def digest(payload):
    """A SHA-1 of a fence-sync payload: the per-unit dicts of numpy arrays
    and scalars, walked in order (keys sorted)."""
    sha = hashlib.sha1()

    def walk(value):
        if isinstance(value, numpy.ndarray):
            sha.update(str((value.dtype.str, value.shape)).encode())
            sha.update(numpy.ascontiguousarray(value).tobytes())
        elif isinstance(value, dict):
            for key in sorted(value):
                sha.update(repr(key).encode())
                walk(value[key])
        elif isinstance(value, (list, tuple)):
            sha.update(b"[%d" % len(value))
            for item in value:
                walk(item)
        else:
            sha.update(repr(value).encode())
    walk(payload)
    return sha.hexdigest()


class _Channel:
    """Pickled objects broadcast from rank 0 over a process group: the
    length first, then the bytes (``torch.distributed.
    broadcast_object_list``'s scheme, with the byte count kept)."""

    def __init__(self, group=None):
        self.group = group
        self._device = None

    @property
    def device(self):
        """Where the broadcast tensors live: the card for NCCL (a rank a
        card), the host for gloo."""
        if self._device is None:
            nccl = torch.distributed.get_backend(self.group) == "nccl"
            self._device = torch.device("cuda" if nccl else "cpu")
        return self._device

    def send(self, obj):
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        size = torch.tensor([len(data)], dtype=torch.int64,
                            device=self.device)
        torch.distributed.broadcast(size, src=0, group=self.group)
        torch.distributed.broadcast(
            torch.frombuffer(bytearray(data), dtype=torch.uint8).to(
                self.device), src=0, group=self.group)
        return len(data)

    def receive(self):
        size = torch.zeros(1, dtype=torch.int64, device=self.device)
        torch.distributed.broadcast(size, src=0, group=self.group)
        buffer = torch.empty(int(size.item()), dtype=torch.uint8,
                             device=self.device)
        torch.distributed.broadcast(buffer, src=0, group=self.group)
        return pickle.loads(buffer.cpu().numpy().tobytes()), buffer.numel()


class PodLeader(Logger):
    """Rank 0's side: hands each event the client applies on to the
    followers. ``stats`` counts the events and bytes by kind and the
    seconds spent handing them on."""

    def __init__(self, group=None):
        super().__init__(logger_name="fleet.PodLeader")
        self.channel = _Channel(group)
        self.ended = False
        self.stats = {"events": {}, "bytes": {}, "seconds": 0.0}

    def hand_on(self, kind, payload=None):
        if self.ended:
            return
        t0 = time.perf_counter()
        size = self.channel.send((kind, payload))
        self.stats["events"][kind] = self.stats["events"].get(kind, 0) + 1
        self.stats["bytes"][kind] = self.stats["bytes"].get(kind, 0) + size
        self.stats["seconds"] += time.perf_counter() - t0

    def end(self):
        """The end of the job stream; safe to call on every exit path,
        and where the followers are gone already."""
        if self.ended:
            return
        try:
            self.hand_on(END)
        except Exception as exc:
            self.warning("could not hand the end on to the followers: %s",
                         exc)
        self.ended = True


class Follower(Logger):
    """A pod slave's rank above 0: receives rank 0's events and applies
    each to its own workflow, stepping the same fused tick; produces no
    update and opens no socket. ``failure`` holds what ended it early (a
    lost world, a failed job, a drift at a fence); ``stats`` the bytes it
    received and its seconds waiting for events and applying them."""

    def __init__(self, workflow, group=None):
        super().__init__(logger_name="fleet.Follower")
        self.workflow = workflow
        self.channel = _Channel(group)
        self.failure = None
        self.jobs_done = 0
        self.rollbacks = 0
        self.stats = {"wait_s": 0.0, "apply_s": 0.0, "bytes": 0}
        self.on_finished = None
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-follower")
        self._thread.start()
        return self

    def join(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)
        return self._thread is None or not self._thread.is_alive()

    def stop(self):
        """A follower ends with rank 0's end event or a lost world; a
        receive in flight cannot be interrupted."""

    def _run(self):
        try:
            while True:
                t0 = time.perf_counter()
                (kind, payload), size = self.channel.receive()
                t1 = time.perf_counter()
                self.stats["wait_s"] += t1 - t0
                self.stats["bytes"] += size
                if kind == END:
                    self.info("rank 0 ended the job stream after %d jobs",
                              self.jobs_done)
                    break
                self._apply(kind, payload)
                self.stats["apply_s"] += time.perf_counter() - t1
        except Exception as exc:
            self.failure = exc
            self.error("the pod follower stopped: %s: %s",
                       type(exc).__name__, exc)
        finally:
            if self.on_finished is not None:
                self.on_finished()

    def _apply(self, kind, payload):
        wf = self.workflow
        if kind == INITIAL:
            wf.apply_initial_data_from_master(payload)
        elif kind == JOB:
            wf._sync_error_ = None
            wf.do_job(payload)
            wf._sync_event_.wait()
            if wf._sync_error_ is not None:
                raise wf._sync_error_[0]
            self.jobs_done += 1
        elif kind == ROLLBACK:
            wf.rollback_job()
            self.rollbacks += 1
        elif kind == FENCE:
            mine = wf.take_fence_sync()
            if mine is None or digest(mine) != payload:
                raise RuntimeError(
                    "the pod's replicas drifted apart: this rank's "
                    "weights at the epoch fence differ from rank 0's")
        else:
            raise ValueError("unknown pod event %r" % (kind,))
