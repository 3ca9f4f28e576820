"""Slave: connects to the master, runs jobs, ships updates.

The port's copy of ``veles_tpu/fleet/client.py``.

Reference ``veles/client.py``. Kept semantics:

- handshake uploads computing power, machine id, pid, backend and the
  workflow checksum (``client.py:362-373``);
- job loop: job_received → do_job (on the workflow's thread pool) →
  update → ack → next request (``client.py:278-354``);
- ``--async-slave`` pipelining: request the next job before the update ack
  (``client.py:294-341``);
- auto-reconnect with an attempt budget, then exit
  (``client.py:488-508``);
- fault injection ``death_probability`` — the slave kills itself mid-job
  with the given probability, exercising the master's requeue path
  (``client.py:438-442``).

Robustness additions over the reference:

- every job carries a ``job_id`` lease and the master's ``epoch``
  (minted per ``Server.start()``); the client echoes both in the update
  so the master can fence duplicates, requeued leases and answers to a
  previous master incarnation (see ``fleet/ledger.py``);
- a welcome with a NEW epoch means the master restarted: the client
  re-handshakes cleanly and restores its reconnect budget;
- the single ``death_probability`` hook generalizes to the seeded
  deterministic chaos harness (``fleet/chaos.py``) wrapping the
  post-handshake frame traffic and the job loop.

Control-plane mode (``root.common.fleet.plane = "control"``,
``docs/compiler_fleet.md``): update frames carry ``results`` (scalar
metrics) plus a local ``tick`` counter instead of weight payloads —
the gradient math stays in this slave's fused tick on its device. The
client keeps exactly-once application without weights on the wire via
the *rollback protocol*: every job frame echoes the master's highest
ACCEPTED tick; a local tick ahead of it means our last application was
never accepted (lost update), so the workflow rolls back its one-slot
params stash before re-applying (sync-mode pipelining bounds the gap
to one job — control-plane mode therefore forces ``async_mode`` off).
Weights cross the wire only at epoch fences (``sync`` frames, resent
until acked) and in the handshake's initial payload — which a
REJOINING client (same master epoch, local ticks applied) skips, since
its device-resident replica is ahead of the master's fence copy.

On a pod slave (``fleet/pod.py``: a slave whose own mesh spans several
ranks of a ``torch.distributed`` world) this client runs on rank 0 and
hands each event it applies on to the other ranks through its
``pod`` leader, in the order it applies them: the handshake's initial
data, each job, each rollback, each epoch fence (a digest of the weights
it ships) and, on every way out of the session, the end of the job
stream.
"""

import asyncio
import os
import random
import threading
import time

from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.fleet import pod as pod_events
from veles_tpu_torch.fleet.protocol import (
    ProtocolError, machine_id, read_frame, resolve_secret, write_frame)
from veles_tpu_torch.observe.fleetscope import get_span_ring
from veles_tpu_torch.observe.metrics import get_metrics_registry
from veles_tpu_torch.observe.tracing import get_tracer, parse_trace_field


class Client(Logger):
    """The fleet slave (reference ``client.py:405``)."""

    #: paused-poll backoff: first retry after PAUSE_POLL_BASE seconds,
    #: doubling up to PAUSE_POLL_MAX — a long-paused slave must not
    #: generate a steady 2 Hz frame stream
    PAUSE_POLL_BASE = 0.5
    PAUSE_POLL_MAX = 8.0

    def __init__(self, address, workflow, power=1.0, async_mode=False,
                 death_probability=0.0, max_reconnect_attempts=7,
                 secret=None, enable_respawn=False, chaos=None,
                 plane=None, pod=None):
        super().__init__(logger_name="fleet.Client")
        #: a pod slave's rank 0: the followers' leader (fleet/pod.py)
        self.pod = pod
        self.enable_respawn = enable_respawn
        host, _, port = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.workflow = workflow
        self._secret = resolve_secret(workflow, secret)
        self.power = power
        if plane is None:
            from veles_tpu_torch.fleet import fleet_plane
            plane = fleet_plane()
        self.plane = plane
        self.control_plane = plane == "control"
        if self.control_plane and async_mode:
            # the one-slot rollback covers exactly ONE in-flight job;
            # pipelined requests would raise the unacknowledged depth
            # past what the stash can replay
            self.warning("control-plane fleet mode is sync-only: "
                         "disabling --async-slave pipelining")
            async_mode = False
        self.async_mode = async_mode
        #: control-plane accounting: locally-applied job count (ships
        #: as ``tick`` in updates; reset when the master epoch changes)
        self._applied_ticks_ = 0
        #: pending epoch-fence weight sync, resent until acked
        self._pending_sync_ = None
        #: rollback-protocol events (re-issued work realigned against
        #: the master's acked tick; the chaos tests assert on this)
        self.rollbacks = 0
        #: the master's handshake-refusal reason, if any (testability)
        self.refusal = None
        self.death_probability = death_probability
        self.max_reconnect_attempts = max_reconnect_attempts
        if chaos is None:
            # default: build from root.common.fleet.chaos (None when no
            # fault is configured); pass chaos=False to force-disable
            from veles_tpu_torch.fleet.chaos import ChaosMonkey
            chaos = ChaosMonkey.from_config()
        self.chaos = chaos or None
        self.sid = None
        self.master_epoch = None
        self.jobs_done = 0
        #: wall ms of the last workflow job run (ships as ``job_ms``
        #: so the master's goodput decomposition can split compute
        #: from host time inside our residence window)
        self._last_job_ms_ = 0.0
        #: cumulative rollback-discarded compute (control plane): work
        #: whose update was lost and re-done bit-identically — ships on
        #: update frames for the master's wasted-work accounting
        self.rollback_ms = 0.0
        # completed-span summaries ride our update frames (observe/
        # fleetscope.py): enable the bounded process ring; it only
        # fills while tracing is on
        get_span_ring().enable()
        self._attempts = 0
        self._loop = None
        self._thread = None
        self._stopped = threading.Event()
        self.on_finished = None

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-client")
        self._thread.start()
        return self

    def _run(self):
        # GC segments a crashed master of a PREVIOUS run never consumed —
        # long-lived clients are senders too (updates ride shm) and must
        # not rely on some future Server.start() to clean /dev/shm
        from veles_tpu_torch.fleet import sharedio
        sharedio.cleanup_stale()
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._session())
        finally:
            self._loop.close()
            if self.pod is not None:
                # every way out of the session: a follower must never
                # wait in a collective for a job that will not come
                self.pod.end()
        if self.on_finished is not None:
            self.on_finished()

    def stop(self):
        self._stopped.set()
        # wake the session coroutine: it is usually parked in read_frame,
        # so close the transport from the loop thread
        if self._loop is not None and self._loop.is_running():
            self._loop.call_soon_threadsafe(self._close_connection)
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _close_connection(self):
        writer = getattr(self, "_writer_", None)
        if writer is not None:
            writer.close()

    def join(self, timeout=None):
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    def update_power(self, power):
        """Re-report computing power mid-run (reference periodic power
        re-upload, client.py:308-313; the master rebalances parked job
        requests by it)."""
        self.power = power

        async def send():
            writer = getattr(self, "_writer_", None)
            if writer is not None:
                await write_frame(writer, {"type": "power",
                                           "power": power}, self._secret)

        if self._loop is not None and self._loop.is_running():
            asyncio.run_coroutine_threadsafe(send(), self._loop)

    # -- session with reconnect budget ---------------------------------------
    async def _session(self):
        self._attempts = 0
        while not self._stopped.is_set():
            try:
                reader, writer = await asyncio.open_connection(
                    self.host, self.port)
            except OSError:
                self._attempts += 1
                if self._attempts > self.max_reconnect_attempts:
                    self.error("gave up reconnecting after %d attempts",
                               self._attempts - 1)
                    return
                await asyncio.sleep(min(0.2 * 2 ** self._attempts, 5.0))
                continue
            self._writer_ = writer
            self._handshaked_ = False
            try:
                done = await self._work(reader, writer)
                if done:
                    return
                self._attempts = 0
            except (asyncio.IncompleteReadError, ConnectionError,
                    ProtocolError) as exc:
                if not self._handshaked_:
                    # the master dropped us mid-handshake (secret/checksum
                    # mismatch shows up as a silent close on its side):
                    # this is NOT a transient network loss — burn an
                    # attempt and back off, or we busy-loop forever
                    self._attempts += 1
                    if self._attempts > self.max_reconnect_attempts:
                        self.error(
                            "master refused the handshake %d times "
                            "(wrong fleet secret or workflow checksum?); "
                            "giving up", self._attempts - 1)
                        return
                    self.warning("handshake failed (%s); retrying",
                                 type(exc).__name__)
                    await asyncio.sleep(min(0.2 * 2 ** self._attempts,
                                            5.0))
                else:
                    self._attempts = 0
                    self.warning("connection to master lost; reconnecting")
                    # breathe before reconnecting: a master that welcomes
                    # then consistently drops would otherwise be hammered
                    # by a zero-backoff loop
                    await asyncio.sleep(0.2)
            finally:
                writer.close()

    async def _work(self, reader, writer):
        from veles_tpu_torch.fleet import sharedio
        hello = {
            "type": "hello", "power": self.power, "mid": machine_id(),
            "pid": os.getpid(),
            # the device the jobs run on: "cuda" or "cpu"
            "backend": getattr(getattr(self.workflow, "device", None),
                               "type", "cpu"),
            # shm eligibility facts: the master enables the /dev/shm data
            # plane only when uid and shm directory match too — a
            # same-machine different-user peer cannot read 0o600 segments
            "uid": sharedio.owner_uid(), "shm_dir": sharedio.shm_dir(),
            # wire-plane agreement is checked at the handshake: a mixed
            # data/control fleet must fail loudly, not stall
            "plane": self.plane,
            "checksum": getattr(self.workflow, "checksum", None)}
        if self.enable_respawn:
            # relaunch recipe for the master's --respawn (reference
            # client.py:362-373 shipped argv/cwd/PYTHONPATH)
            from veles_tpu_torch.fleet.respawn import respawn_recipe
            hello["respawn"] = respawn_recipe()
        await write_frame(writer, hello, self._secret)
        welcome = await read_frame(reader, self._secret)
        if welcome.get("type") == "error":
            self.refusal = welcome.get("error")
            self.error("master refused: %s", self.refusal)
            return True
        self._handshaked_ = True
        self.sid = welcome["id"]
        epoch = welcome.get("epoch")
        # control plane: a rejoin under the SAME master epoch with
        # local applications on record means our device-resident
        # replica is AHEAD of the master's last fence copy — the
        # handshake's initial weights must not clobber it (the
        # rollback protocol realigns any lost tick instead)
        rejoining = (self.control_plane
                     and self.master_epoch is not None
                     and epoch == self.master_epoch
                     and self._applied_ticks_ > 0)
        if self.master_epoch is not None and epoch != self.master_epoch:
            # a NEW epoch means the master restarted (not a network
            # blip): this handshake is a clean re-join — restore the
            # reconnect budget burnt while the master was away
            self.info("master epoch changed (%s -> %s): master "
                      "restarted, re-handshaking cleanly",
                      self.master_epoch, epoch)
            self._attempts = 0
            # the successor's accounting starts fresh: its ledger and
            # acked-tick table know nothing of our prior applications,
            # and its initial payload (applied below) re-seeds state
            self._applied_ticks_ = 0
            self._pending_sync_ = None
        self.master_epoch = epoch
        # master confirmed the same-host shared-memory data plane
        from veles_tpu_torch.fleet.protocol import COMPRESS_THRESHOLD
        self._shm_thr_ = (COMPRESS_THRESHOLD if welcome.get("shm")
                          else None)
        initial = welcome.get("initial")
        if initial and not rejoining:
            self._hand_on(pod_events.INITIAL, initial)
            self.workflow.apply_initial_data_from_master(initial)
        elif initial and rejoining:
            self.info("rejoining the same master epoch with %d local "
                      "tick(s) applied: keeping the device-resident "
                      "replica (handshake weights skipped)",
                      self._applied_ticks_)
        self.info("connected as %s", self.sid)
        # the handshake above never routes through chaos — a fault must
        # not masquerade as an authentication failure; everything below
        # does (self._read/self._write)
        if self.control_plane:
            # an epoch-fence sync the previous connection never got
            # acked goes out FIRST, before any new job can advance the
            # master's accepted-job record past its fence
            await self._flush_sync(writer)
        await self._write(writer, {"type": "job_request"})
        pause_streak = 0
        while not self._stopped.is_set():
            msg = await self._read(reader)
            mtype = msg.get("type")
            if mtype != "job" or not msg.get("paused"):
                pause_streak = 0
            if mtype == "job":
                if msg.get("paused"):
                    # capped exponential backoff: a long-paused slave
                    # must not poll the master at a steady 2 Hz
                    await asyncio.sleep(
                        min(self.PAUSE_POLL_BASE * 2 ** pause_streak,
                            self.PAUSE_POLL_MAX))
                    pause_streak += 1
                    await self._write(writer, {"type": "job_request"})
                    continue
                if msg.get("job") is None:
                    if self.control_plane \
                            and self._pending_sync_ is not None:
                        # belt and braces: never exit with an unacked
                        # fence sync — fire it once more (idempotent
                        # overwrite on the master) so the final
                        # weights cannot stay an epoch stale behind a
                        # lost ack
                        await self._flush_sync(writer)
                    self.info("no more jobs; exiting")
                    return True
                job_id = msg.get("job_id")
                # NTP stamp pair for the master's clock aligner
                # (observe/fleetscope.py): our receive mono now, our
                # send mono stamped just before the update write
                rx_mono = time.monotonic()
                if self.control_plane:
                    self._maybe_rollback(msg)
                # the master's fleet.issue context rides the job frame;
                # our do_job span parents to it and our update echoes
                # OUR context so the master's fleet.apply chains on —
                # one job, one connected trace (docs/observability.md)
                job_span = get_tracer().span(
                    "fleet.do_job",
                    parent=parse_trace_field(msg.get("trace")),
                    job_id=job_id, sid=self.sid)
                with job_span:
                    update = await self._do_job(msg["job"])
                if self.control_plane:
                    # booked the moment the local application exists —
                    # a death between here and the update write leaves
                    # tick > acked, which is exactly what arms the
                    # rollback on the re-issued job
                    self._applied_ticks_ += 1
                if self.chaos is not None:
                    self.chaos.maybe_die(writer)
                if self.death_probability > 0 \
                        and random.random() < self.death_probability:
                    self.warning("fault injection: dying mid-job")
                    os._exit(1)
                shm_thr = getattr(self, "_shm_thr_", None)
                # echo the lease + master epoch: the ledger fences
                # duplicates, requeued leases and stale-epoch answers.
                # Control plane: scalar results + the local tick — the
                # weight payload is omitted ENTIRELY (the master
                # rejects frames that carry one)
                frame = {"type": "update",
                         "job_id": job_id, "epoch": self.master_epoch,
                         # [job-receipt mono, update-send mono]: the
                         # slave half of the clock-alignment exchange;
                         # the send stamp is filled right before write
                         "mono": [rx_mono, 0.0],
                         "job_ms": round(self._last_job_ms_, 3)}
                if self.control_plane:
                    frame["results"] = update
                    frame["tick"] = self._applied_ticks_
                if self.rollback_ms > 0:
                    frame["rollback_ms"] = round(self.rollback_ms, 3)
                if not self.control_plane:
                    frame["update"] = update
                if job_span.context() is not None:
                    frame["trace"] = list(job_span.context())
                ring = get_span_ring()
                if len(ring):
                    # completed-span summaries since the last frame
                    # (bounded rows; the master validates + dedupes)
                    rows = ring.drain()
                    if rows:
                        frame["spans"] = rows
                registry = get_metrics_registry()
                if registry.enabled:
                    # piggyback this slave's counter/gauge snapshot so
                    # the master's /metrics aggregates the whole fleet
                    # without another connection or scrape schedule;
                    # the device-truth collector rides along — the
                    # master re-exports each slave's compile counts
                    # and memory gauges under its slave label. Each row
                    # additionally carries this process's mesh
                    # coordinates (process index + active mesh shape)
                    # so a master scrape distinguishes the SHARDS of a
                    # meshed slave, not just the slaves.
                    from veles_tpu_torch.observe.slo import (
                        ensure_slo_registered)
                    from veles_tpu_torch.observe.xla_stats import (
                        ensure_registered)
                    from veles_tpu_torch.parallel.mesh import (
                        mesh_coordinate_labels)
                    ensure_registered(registry)
                    # a serving slave's SLO gauges ride the same
                    # snapshot: the master re-exports its burn rates
                    # slave-labeled, like the mesh/device rows
                    ensure_slo_registered(registry)
                    coords = sorted(mesh_coordinate_labels().items())
                    frame["metrics"] = [
                        [name, kind,
                         [list(kv) for kv in labels]
                         + [[k, v] for k, v in coords
                            if k not in dict(labels)],
                         value]
                        for name, kind, labels, value
                        in registry.snapshot()]
                    # the metric-history summary rides along
                    # (observe/history.py): the master ingests it
                    # slave-labeled into ITS history, so a master-side
                    # incident autopsy spans the fleet's trends, not
                    # just its own
                    from veles_tpu_torch.observe.history import (
                        get_metric_history)
                    history = get_metric_history()
                    if history is not None and history.samples_total:
                        rows = history.fleet_summary()
                        if rows:
                            frame["history"] = rows
                frame["mono"][1] = time.monotonic()
                await self._write(writer, frame, shm_threshold=shm_thr)
                if self.control_plane:
                    # epoch fence? the workflow hands over the bulk
                    # weight sync exactly once per fence; it is resent
                    # on every (re)connection until the master acks it
                    take = getattr(self.workflow, "take_fence_sync",
                                   None)
                    payload = take() if callable(take) else None
                    if payload is not None:
                        self._hand_on(pod_events.FENCE,
                                      pod_events.digest(payload))
                        self._pending_sync_ = {
                            "job_id": job_id, "sync": payload,
                            "tick": self._applied_ticks_}
                    await self._flush_sync(writer)
                if self.async_mode:
                    # pipelined: next request goes out with the update
                    await self._write(writer, {"type": "job_request"})
            elif mtype == "update_ack":
                if msg.get("fenced"):
                    # the master rejected the (duplicate/stale) update;
                    # this ack is informational — requesting another job
                    # for it would double-feed the pipeline
                    self.warning("master fenced our update: %s",
                                 msg["fenced"])
                elif not self.async_mode:
                    await self._write(writer, {"type": "job_request"})
            elif mtype == "sync_ack":
                if msg.get("fenced"):
                    # the master refused the fence payload (stale epoch
                    # / unaccepted job): a later fence supersedes it —
                    # retrying a refused sync would replay the refusal
                    self.warning("master fenced our sync: %s",
                                 msg["fenced"])
                self._pending_sync_ = None
        return False

    def _maybe_rollback(self, msg):
        """Control-plane rollback protocol: the job frame echoes the
        master's highest ACCEPTED local tick; if we applied more than
        that, our last application's update was lost (death/drop after
        the local math ran) and the incoming job re-issues that work —
        roll the one-slot stash back so the replay is bit-identical."""
        acked = msg.get("acked")
        if not isinstance(acked, int) or isinstance(acked, bool) \
                or self._applied_ticks_ <= acked:
            return
        behind = self._applied_ticks_ - acked
        if behind > 1:
            # cannot happen in sync mode (one job in flight); if it
            # ever does, continuing silently would double-apply work
            self.error(
                "%d unacknowledged local applications but only a "
                "one-slot rollback — local state may have diverged; "
                "re-handshake with a fresh master to re-seed", behind)
            return
        rollback = getattr(self.workflow, "rollback_job", None)
        self._hand_on(pod_events.ROLLBACK)
        rolled = bool(rollback()) if callable(rollback) else False
        if rolled:
            # the discarded application's compute is re-done on the
            # replay — book it as wasted work for the master's goodput
            # accounting (ships cumulative as ``rollback_ms``)
            self.rollback_ms += self._last_job_ms_
        self.rollbacks += 1
        self._applied_ticks_ = acked
        self.warning(
            "master re-issued unacknowledged work (local tick %d -> "
            "acked %d): %s", acked + 1, acked,
            "rolled params back one job" if rolled
            else "eval tick, nothing to restore")

    async def _flush_sync(self, writer):
        """Ship the pending epoch-fence weight sync (if any). Kept
        pending until the master's ``sync_ack`` arrives, so a
        connection lost mid-sync resends it on the next handshake —
        the master's final weights cannot silently stay one epoch
        stale because a fence frame hit a chaos drop."""
        if self._pending_sync_ is None:
            return
        frame = dict(self._pending_sync_)
        frame["type"] = "sync"
        frame["epoch"] = self.master_epoch
        await self._write(writer, frame,
                          shm_threshold=getattr(self, "_shm_thr_",
                                                None))

    def _hand_on(self, kind, payload=None):
        """Hand an event on to a pod slave's followers (rank 0 only)."""
        if self.pod is not None:
            self.pod.hand_on(kind, payload)

    async def _read(self, reader):
        if self.chaos is not None:
            return await self.chaos.read_frame(reader, self._secret)
        return await read_frame(reader, self._secret)

    async def _write(self, writer, message, shm_threshold=None):
        if self.chaos is not None:
            await self.chaos.write_frame(writer, message, self._secret,
                                         shm_threshold=shm_threshold)
        else:
            await write_frame(writer, message, self._secret,
                              shm_threshold=shm_threshold)

    async def _do_job(self, job):
        """Run the whole workflow locally on the job (reference
        ``workflow.py:554-569``), off the event loop."""
        loop = asyncio.get_event_loop()
        future = loop.create_future()

        def callback(update):
            loop.call_soon_threadsafe(future.set_result, update)

        def launch():
            self._hand_on(pod_events.JOB, job)
            self.workflow.do_job(job, callback)

        started = time.monotonic()
        await loop.run_in_executor(None, launch)
        update = await future
        # the workflow's own wall only: the chaos slow-slave stretch
        # below is injected residence the goodput decomposition must
        # book as HOST time, not compute
        self._last_job_ms_ = (time.monotonic() - started) * 1000.0
        if self.chaos is not None:
            await self.chaos.stretch_job()  # slow-slave fault
        self.jobs_done += 1
        return update
