"""Master: serves jobs, merges updates, manages the slave fleet.

The port's copy of ``veles_tpu/fleet/server.py``. Its asyncio thread
runs the workflow's job and update hooks on an executor thread under
``_update_lock``; the units hand the wire numpy arrays and take them
back as tensors on their device (default stream).

Reference ``veles/server.py``. Kept semantics:

- handshake validates the workflow checksum and assigns slave ids
  (``server.py:478-529``);
- job pipeline with backpressure: a "not ready" workflow answer queues the
  slave's request, replayed after the next update (``server.py:369-399``);
- update application serialized through the workflow's aggregation lock
  and run off the event loop (``server.py:401-430``);
- hang detection: per-slave job-duration history, timeout =
  max(mean + 3σ, job_timeout) → drop + blacklist
  (``server.py:619-635``);
- elasticity: ``drop_slave`` propagates so the Loader requeues pending
  minibatches; slaves may join/leave at any time;
- per-slave pause/resume and reverse-DNS naming kept as attributes on
  SlaveDescription.
"""

import asyncio
import os
import threading
import time
import uuid

from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.fleet.ledger import FENCE_STALE_EPOCH, JobLedger
from veles_tpu_torch.fleet.protocol import (
    COMPRESS_THRESHOLD, ProtocolError, machine_id, read_frame,
    resolve_secret, write_frame)
from veles_tpu_torch.observe.fleetscope import FleetScope, StepWindow
from veles_tpu_torch.observe.flight import get_flight_recorder
from veles_tpu_torch.observe.metrics import bridge, publish_fleet
from veles_tpu_torch.observe.tracing import get_tracer, parse_trace_field


class SlaveDescription:
    """Fleet-roster entry (reference ``server.py:172``)."""

    #: job-duration history cap: the mean+3sigma hang threshold must track
    #: the slave's RECENT speed, not be skewed by ancient samples (and the
    #: list must not grow unboundedly over long runs)
    JOB_TIMES_KEEP = 100

    def __init__(self, sid, info):
        self.id = sid
        self.mid = info.get("mid", "?")
        # coerce ONCE at ingestion: every consumer (logs, status API,
        # power-weighted retry sort) can then rely on a float
        try:
            self.power = float(info.get("power", 1.0))
        except (TypeError, ValueError):
            self.power = 1.0
        self.pid = info.get("pid", 0)
        self.backend = info.get("backend", "?")
        self.state = "WAIT"
        self.jobs_done = 0
        #: per-slave step-time history: ONE implementation
        #: (observe/fleetscope.py StepWindow) behind the adaptive hang
        #: timeout AND the fleet straggler detector — the server shares
        #: this window with its FleetScope via ``track_window``
        self.window = StepWindow(keep=self.JOB_TIMES_KEEP)
        self.job_started = None
        self.paused = False
        self.chaos_counters = None  # latest fault tallies from the slave
        #: latest counter/gauge snapshot piggybacked on this slave's
        #: update frames (observe/metrics.py snapshot() rows); the
        #: master's /metrics re-exports them with a slave label
        self.metrics_rows = None
        #: latest metric-history summary piggybacked the same way
        #: (observe/history.py fleet_summary() rows) — ingested
        #: slave-labeled into the master's history so its incident
        #: autopsies span the fleet
        self.history_rows = None

    @property
    def job_times(self):
        """The raw step-time samples (compat view of the window)."""
        return self.window.samples

    def record_job_time(self, duration):
        self.window.push(duration)

    def timeout(self, default):
        """mean + 3σ adaptive hang threshold (reference
        ``server.py:619-635``), read from the SAME window the
        straggler detector scores."""
        return self.window.hang_timeout(default)

    def as_dict(self):
        return {"id": self.id, "mid": self.mid, "pid": self.pid,
                "power": self.power, "state": self.state,
                "jobs_done": self.jobs_done, "paused": self.paused}


class Server(Logger):
    """The fleet master (reference ``server.py:659``)."""

    #: per-slave piggybacked-metrics bounds (see :meth:`slave_metrics`)
    METRICS_MAX_ROWS = 512
    METRICS_MAX_LABELS = 8
    METRICS_MAX_VALUE_LEN = 256

    def __init__(self, address, workflow, job_timeout=120.0, secret=None,
                 respawn=False, spawner=None, metrics_port=None,
                 plane=None):
        super().__init__(logger_name="fleet.Server")
        #: wire plane (docs/compiler_fleet.md): "data" (reference
        #: protocol, weights ride every frame) or "control" (batch
        #: assignments + scalar metrics only; weights cross the wire in
        #: the handshake and at epoch-fence ``sync`` frames while the
        #: gradient math stays in the slave's fused tick). Both
        #: sides must agree — the handshake rejects mismatches.
        if plane is None:
            from veles_tpu_torch.fleet import fleet_plane
            plane = fleet_plane()
        self.plane = plane
        self.control_plane = plane == "control"
        #: control-plane rollback protocol: last ACCEPTED local-tick
        #: counter and last accepted job per client PROCESS (mid, pid)
        #: — keyed by process, not sid, so the accounting survives
        #: reconnects (a re-joined slave gets a fresh sid)
        self._acked_ticks = {}
        self._accepted_jobs = {}
        #: epoch-fence weight-sync accounting (control plane)
        self._sync_counters = {"applied": 0, "fenced": 0}
        #: accepted results since the last applied fence sync — a
        #: FRESH process joining with this > 0 means mid-epoch
        #: progress lived only on a dead replica (control-plane
        #: process-loss recovery is epoch-granularity; the join warns)
        self._jobs_since_sync = 0
        #: latest in-program-reduce stats per client process (mid, pid)
        #: mined from the piggybacked metric rows — persisted like
        #: _chaos_reports so fleet_status() can still report the reduce
        #: plane after a slave disconnects (the dashboard's proof the
        #: math stayed on the chip)
        self._reduce_reports = {}
        #: frames carrying a data-plane ``update`` payload on a
        #: control-plane wire, rejected (never applied) — see
        #: :meth:`_apply_update`
        self._payload_rejects = 0
        host, _, port = address.rpartition(":")
        # loopback by default: an exposed master means remote code
        # execution for anyone with the secret — opt in explicitly
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.workflow = workflow
        self._secret, source = resolve_secret(workflow, secret,
                                              with_source=True)
        self.secret_source = source
        # --respawn: relaunch dead slaves on their hosts (reference
        # server.py:637-655); see fleet/respawn.py
        self.respawn_manager = None
        if respawn:
            from veles_tpu_torch.fleet.respawn import RespawnManager
            self.respawn_manager = RespawnManager(
                spawner=spawner, extra_env=self.secret_spawn_env())
        if source == "checksum" \
                and self.host not in ("127.0.0.1", "localhost", "::1"):
            self.warning(
                "fleet secret defaulted to the workflow checksum on a "
                "non-loopback bind (%s) — anyone with the workflow source "
                "can compute it; set VELES_TPU_FLEET_SECRET or "
                "root.common.fleet.secret for real deployments", self.host)
        self.job_timeout = job_timeout
        self.slaves = {}
        self.blacklist = set()
        #: job-level accounting: leases, explicit requeue, update fencing
        self.ledger = JobLedger()
        #: master-generation fence, minted at start(); echoed in every
        #: post-welcome frame so updates addressed to a previous master
        #: incarnation are rejected, not applied (see fleet/ledger.py)
        self.epoch = None
        #: latest chaos tallies per client process (mid, pid): counters
        #: are cumulative per process, so keeping the last report per
        #: process survives reconnects without double counting
        self._chaos_reports = {}
        #: the fleet goodput observatory (observe/fleetscope.py):
        #: per-slave step windows + clock alignment + shipped-span
        #: store + goodput decomposition + the straggler detector
        self.scope = FleetScope()
        self._next_id = 0
        self._pending_requests = []  # backpressured (sid, writer)
        self._writers = {}
        self._update_lock = threading.Lock()
        self._loop = None
        self._server = None
        self._thread = None
        self._stopped = threading.Event()
        self.on_finished = None  # callback when the job stream is done
        #: fleet-wide Prometheus sidecar (docs/observability.md): the
        #: fleet wire protocol is custom asyncio frames, so /metrics
        #: needs its own tiny HTTP listener. Off by default (None);
        #: 0 binds an ephemeral port, resolved after start().
        if metrics_port is None:
            metrics_port = root.common.observe.get("fleet_metrics_port",
                                                   None)
        self.metrics_port = metrics_port
        self._metrics_httpd = None

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        """Run the asyncio server in a dedicated thread (the reactor role;
        reference ran Twisted as the main loop, but here the workflow owns
        the main thread)."""
        self.epoch = uuid.uuid4().hex
        ready = threading.Event()

        def run_loop():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            coro = asyncio.start_server(self._handle_slave, self.host,
                                        self.port)
            self._server = self._loop.run_until_complete(coro)
            if not self.port:
                self.port = self._server.sockets[0].getsockname()[1]
            ready.set()
            # periodic shm GC: sender-side orphans (peer died between
            # segment creation and descriptor delivery) accumulate in
            # long runs unless someone sweeps mid-run
            self._loop.call_later(900.0, self._periodic_shm_gc)
            self._loop.run_forever()
            self._server.close()
            self._loop.run_until_complete(self._server.wait_closed())
            self._loop.close()

        self._thread = threading.Thread(target=run_loop, daemon=True,
                                        name="fleet-server")
        self._thread.start()
        ready.wait()
        # GC shm segments orphaned by crashed receivers of PREVIOUS runs
        from veles_tpu_torch.fleet import sharedio
        stale = sharedio.cleanup_stale()
        if stale:
            self.info("removed %d stale shared-memory segments", stale)
        self.info("master listening on %s:%d", self.host, self.port)
        if self.metrics_port is not None:
            self._start_metrics_server()
        return self

    def _start_metrics_server(self):
        """The /metrics HTTP sidecar: fleet_status() + every slave's
        piggybacked counters in one Prometheus exposition."""
        from http.server import BaseHTTPRequestHandler
        from veles_tpu_torch.core.httpd import (QuietHandlerMixin,
                                          enable_metrics, reply,
                                          serve_metrics, start_server)

        server = self
        bridge(enable_metrics(), self, publish_fleet)

        class Handler(QuietHandlerMixin, BaseHTTPRequestHandler):
            def do_GET(self):
                if serve_metrics(self):
                    return
                path = self.path.split("?")[0]
                if path == "/healthz":
                    reply(self, server.fleet_status())
                    return
                if path == "/debug/fleet":
                    # the fleet-trace payload (observe/fleetscope.py):
                    # master spans + shipped slave spans + clocks +
                    # goodput, assembled by `observe fleet-trace`
                    reply(self, server.fleet_debug())
                    return
                if path in ("/debug", "/debug/"):
                    # the debug index (core/httpd.serve_debug_index
                    # contract): this sidecar mounts the fleet payload
                    reply(self, {"surfaces": {
                        "/debug/fleet": "fleet goodput observatory: "
                        "master+slave spans, clocks, straggler "
                        "verdict (observe/fleetscope.py; assemble "
                        "with `veles_tpu_torch observe fleet-trace`)"}})
                    return
                self.send_error(404)

        self._metrics_httpd, self.metrics_port = start_server(
            Handler, self.host, int(self.metrics_port),
            name="fleet-metrics")
        self.info("fleet metrics on http://%s:%d/metrics", self.host,
                  self.metrics_port)

    def kick(self):
        """Replay backpressured job requests. The task farm calls this
        after submit() so parked slaves re-request without waiting for
        the next update (which, between GA generations, never comes)."""
        if self._loop is not None and not self._stopped.is_set():
            asyncio.run_coroutine_threadsafe(self._retry_pending(),
                                             self._loop)

    def drain(self, timeout=10.0):
        """Block until every slave has disconnected or gone IDLE (all
        parked requests answered). Call between kick() and stop() so the
        clean 'no more jobs' frames actually reach the slaves before the
        event loop dies."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            # snapshot slaves: the event-loop thread mutates the dict
            slaves = list(self.slaves.values())
            if not self._pending_requests and all(
                    s.state in ("IDLE",) for s in slaves):
                return True
            time.sleep(0.05)
        return False

    def stop(self):
        if self._stopped.is_set():
            return
        self._stopped.set()
        if self._metrics_httpd is not None:
            self._metrics_httpd.shutdown()
            self._metrics_httpd = None
        if self.respawn_manager is not None:
            self.respawn_manager.stop()
        if self._loop is not None:
            def shutdown():
                # close live slave transports BEFORE the loop dies: a
                # stopped loop never runs its suspended handlers again,
                # so an un-closed socket would leave parked slaves
                # waiting forever instead of reconnecting to our
                # successor (the master-restart recovery path)
                for writer in list(self._writers.values()):
                    writer.close()
                self._loop.stop()

            self._loop.call_soon_threadsafe(shutdown)
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    @property
    def address(self):
        return "%s:%d" % (self.host, self.port)

    def secret_spawn_env(self):
        """Env vars a spawned slave needs to authenticate. When the
        secret came from the master's environment or an explicit
        ``secret=``, a remote slave cannot re-derive it (config and
        checksum travel with the workflow source; env does not) — every
        frame would fail HMAC and the slave could never join."""
        if self.secret_source not in ("env", "explicit"):
            return {}
        try:
            value = self._secret.decode("utf-8")
        except UnicodeDecodeError:
            self.warning(
                "fleet secret is not UTF-8 text; cannot forward it to "
                "spawned slaves via VELES_TPU_FLEET_SECRET — remote "
                "-n/--respawn slaves will fail to authenticate")
            return {}
        if value != value.strip() or "\n" in value or "\r" in value:
            # the ssh stdin NAME=value line protocol would truncate or
            # corrupt it (and `read` trims IFS whitespace)
            self.warning(
                "fleet secret contains whitespace/newlines; cannot "
                "forward it to spawned slaves — use a single-line "
                "secret for remote -n/--respawn")
            return {}
        return {"VELES_TPU_FLEET_SECRET": value}

    # -- per-slave protocol ---------------------------------------------------
    async def _handle_slave(self, reader, writer):
        sid = None
        try:
            # pre-auth frame: tiny cap (the hello is a small dict) so an
            # unauthenticated peer cannot balloon our memory
            hello = await read_frame(reader, self._secret,
                                     max_frame=1 << 16)
            if hello.get("type") != "hello":
                await write_frame(writer, {"type": "error",
                                           "error": "bad handshake"},
                                  self._secret)
                return
            if hello.get("mid") in self.blacklist:
                await write_frame(writer, {"type": "error",
                                           "error": "blacklisted"},
                                  self._secret)
                return
            checksum = getattr(self.workflow, "checksum", None)
            # REQUIRED equality: a missing checksum is a mismatch too —
            # a slave on different code must never join silently
            if hello.get("checksum") != checksum:
                await write_frame(writer, {
                    "type": "error",
                    "error": "workflow checksum mismatch"}, self._secret)
                self.warning("rejected slave with wrong workflow checksum")
                return
            # both sides must run the SAME wire plane: a data-plane
            # slave joining a control-plane master would ship weight
            # payloads the master rejects (and vice versa would starve
            # the master of weights entirely) — fail the handshake with
            # a message naming the knob instead of stalling later
            peer_plane = hello.get("plane", "data")
            if peer_plane != self.plane:
                await write_frame(writer, {
                    "type": "error",
                    "error": "fleet plane mismatch (master=%s, slave="
                             "%s): set root.common.fleet.plane / "
                             "--fleet-plane identically on every host"
                             % (self.plane, peer_plane)}, self._secret)
                self.warning("rejected slave with mismatched fleet "
                             "plane %r (ours: %r)", peer_plane,
                             self.plane)
                return
            self._next_id += 1
            sid = "slave-%d" % self._next_id
            slave = SlaveDescription(sid, hello)
            slave.respawn_recipe = hello.get("respawn")
            peer = writer.get_extra_info("peername")
            slave.peer_host = peer[0] if peer else "127.0.0.1"
            # same-host fast path (reference SharedIO, server.py:721-732):
            # matching machine ids move big payloads via /dev/shm
            # segments — but only when uid and shm directory match too
            # (0o600 segments are unreadable across users; differing
            # shm_dir fallbacks would 404 every descriptor)
            from veles_tpu_torch.fleet import sharedio
            shm_ok = (slave.mid != "?" and slave.mid == machine_id()
                      and hello.get("uid") == sharedio.owner_uid()
                      and hello.get("shm_dir") == sharedio.shm_dir()
                      and root.common.fleet.get("shm", True))
            slave.shm_threshold = COMPRESS_THRESHOLD if shm_ok else None
            self.slaves[sid] = slave
            self._writers[sid] = writer
            # the hang timeout and the straggler detector read ONE
            # step-time window (observe/fleetscope.py)
            self.scope.track_window(sid, slave.window)
            initial = await self._in_thread(self._locked_initial, slave)
            await write_frame(writer, {"type": "welcome", "id": sid,
                                       "shm": shm_ok, "epoch": self.epoch,
                                       "initial": initial}, self._secret,
                              shm_threshold=slave.shm_threshold)
            self.info("slave %s connected (mid=%s power=%.1f)", sid,
                      slave.mid, slave.power)
            if self.control_plane and self._jobs_since_sync > 0 \
                    and (slave.mid, slave.pid) not in self._acked_ticks:
                # a FRESH process (not a reconnect of a live replica)
                # joined while settled mid-epoch work exists only on a
                # dead replica: it starts from the last epoch fence —
                # control-plane process-loss recovery is
                # epoch-granularity by design (docs/compiler_fleet.md
                # decision table); say so LOUDLY instead of silently
                # dropping those applications from the trajectory
                self.warning(
                    "control-plane slave %s is a fresh process but %d "
                    "accepted job(s) since the last epoch-fence sync "
                    "lived on a departed replica — it resumes from "
                    "the fence weights; that mid-epoch progress is "
                    "lost to the weight trajectory (use the data "
                    "plane if per-minibatch durability across process "
                    "deaths matters — docs/compiler_fleet.md)",
                    sid, self._jobs_since_sync)
            while not self._stopped.is_set():
                msg = await read_frame(reader, self._secret)
                mtype = msg.get("type")
                if mtype == "job_request":
                    await self._serve_job(slave, writer)
                elif mtype == "update":
                    await self._apply_update(slave, writer, msg)
                elif mtype == "sync":
                    await self._apply_sync(slave, writer, msg)
                elif mtype == "power":
                    try:
                        slave.power = float(msg.get("power"))
                    except (TypeError, ValueError):
                        self.warning("ignoring non-numeric power from %s",
                                     slave.id)
                elif mtype == "bye":
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except ProtocolError as exc:
            peer = writer.get_extra_info("peername")
            self.warning("dropping peer %s: %s", peer, exc)
        except Exception:
            self.exception("slave handler failed")
        finally:
            if sid is not None:
                self._drop(sid)
            writer.close()

    async def _serve_job(self, slave, writer):
        if slave.paused:
            await write_frame(writer, {"type": "job", "job": None,
                                       "paused": True}, self._secret)
            return
        slave.state = "GETTING_JOB"
        job = await self._in_thread(self._locked_generate, slave)
        if job is False:
            # backpressure: some unit not ready — queue the request,
            # replayed after the next update (reference server.py:369-399)
            self._pending_requests.append((slave.id, writer))
            return
        if job is None:
            slave.state = "IDLE"
            await write_frame(writer, {"type": "job", "job": None},
                              self._secret)
            self._maybe_finished()
            return
        slave.state = "WORK"
        slave.job_started = time.time()
        # lease: deadline from the slave's adaptive timeout; the update
        # must echo the job_id (exactly-once fence) and our epoch
        timeout = slave.timeout(self.job_timeout)
        job_id = self.ledger.issue(slave.id, timeout)
        frame = {"type": "job", "job": job, "job_id": job_id,
                 "epoch": self.epoch}
        if self.control_plane:
            # rollback protocol: the highest local tick we ACCEPTED
            # from this process. A slave holding a higher local tick
            # knows its last application was never accepted (lost
            # update) and must roll it back before applying this job —
            # that is what keeps re-issued work bit-identical without
            # weights on the wire (docs/compiler_fleet.md)
            frame["acked"] = self._acked_ticks.get(
                (slave.mid, slave.pid), 0)
        # trace propagation (docs/observability.md): the issue event
        # roots the job's trace; its context rides the frame, the slave
        # parents its do_job span to it and echoes ITS context in the
        # update, so one fleet job reads master -> slave -> apply
        issue = get_tracer().event("fleet.issue", job_id=job_id,
                                   slave=slave.id)
        if issue.context() is not None:
            frame["trace"] = list(issue.context())
        # clock-alignment t0: the job-send stamp this lease's update
        # round trip is measured against (observe/fleetscope.py)
        self.scope.note_issue(job_id, slave, time.monotonic())
        await write_frame(writer, frame, self._secret,
                          shm_threshold=getattr(slave, "shm_threshold",
                                                None))
        self._watch_hang(slave, job_id, timeout)

    async def _apply_update(self, slave, writer, msg):
        if isinstance(msg.get("chaos"), dict):
            # the slave's fault-injection tallies ride its updates so the
            # dashboard can prove each configured fault actually fired
            slave.chaos_counters = msg["chaos"]
            self._chaos_reports[(slave.mid, slave.pid)] = msg["chaos"]
        if isinstance(msg.get("metrics"), list):
            # counter/gauge snapshot piggybacked on the update frame —
            # the master's /metrics re-exports it under this slave's
            # id; truncated at INGESTION so an oversized hostile list
            # is never retained past the frame
            slave.metrics_rows = msg["metrics"][:self.METRICS_MAX_ROWS]
            entry = self._mine_reduce_rows(slave.metrics_rows)
            if entry:
                self._reduce_reports[(slave.mid, slave.pid)] = \
                    (slave.id, entry)
        if isinstance(msg.get("history"), list):
            # the slave's trend summary (observe/history.py): bounded
            # at ingestion like the metrics rows, then landed
            # slave-labeled in the master's own history — a
            # master-side incident artifact reports the whole fleet's
            # breaching windows (ingest_summary validates the rows)
            from veles_tpu_torch.observe.history import (FLEET_MAX_SERIES,
                                                   get_metric_history)
            slave.history_rows = msg["history"][:FLEET_MAX_SERIES]
            master_history = get_metric_history()
            if master_history is not None:
                master_history.ingest_summary(slave.id,
                                              slave.history_rows)
        # span-summary + clock-stamp ingestion (observe/fleetscope.py;
        # validated + bounded like the metric rows above): runs for
        # every frame — even a frame the fence later rejects carries
        # real spans and a real round trip
        update_mono = time.monotonic()
        stamp_pair = self.scope.note_update(slave, msg, update_mono)
        if self.control_plane and "update" in msg:
            # a data-plane weight payload on the control-plane wire is
            # a protocol violation (zombie or misconfigured peer
            # shipping stale weights a future refactor might apply) —
            # REJECT it loudly BEFORE the fence consumes the lease: the
            # job stays OUTSTANDING, so the hang timer requeues the
            # work and liveness survives the violator
            self._payload_rejects += 1
            self.warning(
                "rejected update from %s: frame carries a data-plane "
                "'update' payload on a control-plane wire (job_id=%r) "
                "— weights never ride updates in this mode", slave.id,
                msg.get("job_id"))
            get_flight_recorder().note("fleet.payload_reject",
                                       slave=slave.id,
                                       job_id=msg.get("job_id"))
            await write_frame(writer, {"type": "update_ack",
                                       "fenced": "payload-rejected"},
                              self._secret)
            slave.state = "WAIT"
            await self._retry_pending()
            return
        results = msg.get("results" if self.control_plane else "update")
        if results is None:
            # a metrics-only keepalive: no completed-work bookkeeping
            # (jobs_done/job timing/respawn budget) AND no lease
            # consumption — settling it would mark work DONE whose
            # results never arrived, silently dropping that minibatch
            # from the run (the hang timer requeues the lease instead)
            self.warning("update from %s carried no results (job_id="
                         "%r) — acked, lease left outstanding, not "
                         "counted as completed work", slave.id,
                         msg.get("job_id"))
            await write_frame(writer, {"type": "update_ack",
                                       "fenced": "no-results"},
                              self._secret)
            slave.state = "WAIT"
            await self._retry_pending()
            return
        verdict = self._fence_update(slave, msg)
        if verdict is not None:
            self.warning("fenced update from %s: %s (job_id=%r)",
                         slave.id, verdict, msg.get("job_id"))
            self._note_fence(verdict, slave.id, msg.get("job_id"))
            # still ack (flagged) so a sync slave doesn't stall — it
            # skips the job_request for fenced acks
            await write_frame(writer, {"type": "update_ack",
                                       "fenced": verdict}, self._secret)
            slave.state = "WAIT"
            await self._retry_pending()
            return
        if slave.job_started is not None:
            slave.record_job_time(time.time() - slave.job_started)
            slave.job_started = None
        slave.jobs_done += 1
        # goodput decomposition: the accepted update's round trip
        # splits into compute/host/wire, the gap since this slave's
        # previous settle into idle (observe/fleetscope.py)
        self.scope.book_update(slave.id, stamp_pair, update_mono)
        if slave.jobs_done == 1 and self.respawn_manager is not None \
                and slave.mid != "?":
            # reset the respawn budget only once the slave proves it
            # can WORK — resetting at handshake would let a
            # crash-on-init loop respawn forever at base delay
            self.respawn_manager.notify_reconnected(slave.mid)
        with get_tracer().span(
                "fleet.apply",
                parent=parse_trace_field(msg.get("trace")),
                job_id=msg.get("job_id"), slave=slave.id):
            await self._in_thread(self._locked_apply, results, slave)
        if self.control_plane:
            key = (slave.mid, slave.pid)
            tick = msg.get("tick")
            if isinstance(tick, int) and not isinstance(tick, bool):
                self._acked_ticks[key] = tick
            if isinstance(msg.get("job_id"), int):
                self._accepted_jobs[key] = msg["job_id"]
            self._jobs_since_sync += 1
        # straggler detection + trend recording + (cooldown-limited)
        # fleet incident artifact — OFF the record path by design
        # (observe/fleetscope.py autopsy_tick may write a file)
        from veles_tpu_torch.observe.history import get_metric_history
        self.scope.autopsy_tick(
            slave.id, get_metric_history(),
            wasted_s=self.ledger.snapshot().get("wasted_s", 0.0))
        await write_frame(writer, {"type": "update_ack"}, self._secret)
        slave.state = "WAIT"
        await self._retry_pending()

    async def _apply_sync(self, slave, writer, msg):
        """Epoch-fence weight sync (control plane): the only frames
        that carry weights after the handshake. Fenced like updates —
        a stale master epoch (zombie from a previous incarnation) or a
        job the ledger never accepted from this process means the
        weights are rejected, never applied. Re-application of the
        SAME accepted fence (the client resends until acked) is an
        idempotent overwrite."""
        verdict = None
        if not self.control_plane:
            verdict = "not-control-plane"
        elif msg.get("epoch") != self.epoch:
            verdict = FENCE_STALE_EPOCH
        elif msg.get("job_id") is None or msg.get("job_id") != \
                self._accepted_jobs.get((slave.mid, slave.pid)):
            # the sync must chase an update WE accepted from THIS
            # process — a zombie's fence payload (its job was requeued
            # and re-run elsewhere) never lands
            verdict = "unsettled-job"
        if verdict is not None:
            self._sync_counters["fenced"] += 1
            self.warning("fenced sync from %s: %s (job_id=%r)",
                         slave.id, verdict, msg.get("job_id"))
            get_flight_recorder().note("fleet.sync_fence",
                                       verdict=verdict, slave=slave.id,
                                       job_id=msg.get("job_id"))
            await write_frame(writer, {"type": "sync_ack",
                                       "fenced": verdict}, self._secret)
            return
        payload = msg.get("sync")
        if payload is not None:
            await self._in_thread(self._locked_apply_sync, payload,
                                  slave)
            self._sync_counters["applied"] += 1
            self._jobs_since_sync = 0
        await write_frame(writer, {"type": "sync_ack"}, self._secret)

    def _locked_apply_sync(self, payload, slave):
        with self._update_lock:
            apply = getattr(self.workflow, "apply_sync_from_slave",
                            None)
            if apply is not None:
                apply(payload, slave)
            else:
                self.warning("workflow has no apply_sync_from_slave — "
                             "fence sync from %s dropped", slave.id)

    def _fence_update(self, slave, msg):
        """Judge an update before it can touch master state. Returns
        ``None`` (apply it) or the fence verdict string (reject): unknown/
        duplicate/requeued/foreign ``job_id`` via the ledger, or a stale
        master ``epoch`` (the update answers a previous incarnation)."""
        if msg.get("epoch") != self.epoch:
            return self.ledger.count_stale_epoch()
        return self.ledger.settle(msg.get("job_id"), slave.id)

    def _note_fence(self, verdict, sid, job_id):
        """Fence verdicts go to the black box; a STALE-EPOCH fence —
        a zombie answering a previous master incarnation — dumps it,
        because by then the interesting history is about to scroll out
        of the ring (docs/observability.md). Dumped ONCE per slave: a
        zombie replaying stale frames must not turn each one into
        synchronous dump I/O on the event loop (later frames still
        note into the ring)."""
        flight = get_flight_recorder()
        flight.note("fleet.fence", verdict=verdict, slave=sid,
                    job_id=job_id)
        if verdict != FENCE_STALE_EPOCH:
            return
        dumped = getattr(self, "_fence_dumped_", None)
        if dumped is None:
            dumped = self._fence_dumped_ = set()
        if sid in dumped:
            return
        dumped.add(sid)
        flight.dump("epoch_fence",
                    extra={"slave": sid, "job_id": job_id,
                           "epoch": self.epoch,
                           "ledger": self.ledger.snapshot()})

    def _locked_apply(self, update, slave):
        with self._update_lock:
            self.workflow.apply_data_from_slave(update, slave)

    def _locked_initial(self, slave):
        # the handshake payload reads the same unit state the updates
        # replace: the port copies it to numpy under the lock
        with self._update_lock:
            return self.workflow.generate_initial_data_for_slave(slave)

    def _locked_generate(self, slave):
        # concurrent job requests from 2+ slaves run on different executor
        # threads; the Loader's serve is read-modify-write state
        with self._update_lock:
            return self.workflow.generate_data_for_slave(slave)

    async def _retry_pending(self):
        pending, self._pending_requests = self._pending_requests, []
        # power-weighted balancing (reference workflow.py:613-619 +
        # DeviceBenchmark power): when several slaves are parked, the
        # strongest gets the next job first

        pending.sort(key=lambda item: -getattr(
            self.slaves.get(item[0]), "power", 0.0))
        for sid, writer in pending:
            slave = self.slaves.get(sid)
            if slave is not None:
                await self._serve_job(slave, writer)

    def _watch_hang(self, slave, job_id, timeout):
        def check():
            if self.slaves.get(slave.id) is not slave:
                # the slave already dropped (death/disconnect): a stale
                # timer must NOT blacklist its machine-id posthumously —
                # that would ban every future (e.g. respawned) slave of
                # that host
                return
            # per-lease expiry: only fires when THIS job is still
            # OUTSTANDING past its deadline (the old elapsed-time check
            # could misread a later, faster job); marking it REQUEUED
            # arms the fence against the zombie's eventual late update
            if self.ledger.expire_if_outstanding(job_id):
                self.warning("slave %s hanged on job %d (> %.1fs); "
                             "dropping + blacklisting", slave.id, job_id,
                             timeout)
                if slave.mid != "?":
                    # never blacklist the unknown-mid placeholder: one
                    # anonymous hang would ban every future such slave
                    self.blacklist.add(slave.mid)
                writer = self._writers.get(slave.id)
                if writer is not None:
                    writer.close()

        self._loop.call_later(timeout + 1.0, check)

    def _drop(self, sid):
        slave = self.slaves.pop(sid, None)
        if slave is not None:
            slave.job_started = None  # disarm any in-flight hang timer
        # scoring hygiene: a departed slave leaves the straggler
        # detector's reference pool (observe/fleetscope.py)
        self.scope.drop_slave(sid)
        # explicit job-level requeue: every lease still OUTSTANDING for
        # this slave transitions to REQUEUED (the workflow's drop_slave
        # below requeues the actual minibatch payloads) and its late
        # update, should the peer resurface, is fenced
        requeued = self.ledger.requeue_for_slave(sid)
        if requeued:
            self.info("requeued %d outstanding lease(s) of %s: %s",
                      len(requeued), sid, requeued)
        self._writers.pop(sid, None)
        self._pending_requests = [
            (s, w) for s, w in self._pending_requests if s != sid]
        if slave is not None:
            self.info("slave %s dropped", sid)
            with self._update_lock:
                self.workflow.drop_slave(slave)
            if self.respawn_manager is not None \
                    and not self._stopped.is_set() \
                    and getattr(slave, "respawn_recipe", None) \
                    and slave.mid not in self.blacklist \
                    and self.workflow.has_more_jobs():
                self.respawn_manager.schedule(
                    getattr(slave, "peer_host", "127.0.0.1"),
                    slave.respawn_recipe,
                    key=slave.mid if slave.mid != "?" else sid)
        self._maybe_finished()

    def _maybe_finished(self):
        if not self.workflow.has_more_jobs() \
                and all(s.state == "IDLE" for s in self.slaves.values()):
            if self.on_finished is not None:
                self.on_finished()

    # -- helpers --------------------------------------------------------------
    def _periodic_shm_gc(self):
        if self._stopped.is_set():
            return

        def sweep():
            # off the event loop: a large /dev/shm walk must not stall
            # the frame-serving coroutines
            from veles_tpu_torch.fleet import sharedio
            stale = sharedio.cleanup_stale()
            if stale:
                self.info("removed %d stale shared-memory segments",
                          stale)

        self._loop.run_in_executor(None, sweep)
        self._loop.call_later(900.0, self._periodic_shm_gc)

    async def _in_thread(self, fn, *args):
        return await self._loop.run_in_executor(None, fn, *args)

    def pause_slave(self, sid):
        if sid in self.slaves:
            self.slaves[sid].paused = True

    def resume_slave(self, sid):
        if sid in self.slaves:
            self.slaves[sid].paused = False

    def slave_metrics(self):
        """Per-slave piggybacked metric snapshots, validated: the rows
        came off the wire, so anything not shaped like a snapshot row
        (``[name, kind, [[k, v], ...], number]``) is dropped — metric
        and label NAMES must be valid exposition tokens (label values
        are escaped by the registry), so a hostile or version-skewed
        slave can at most contribute bogus VALUES, never break the
        master's exposition. Volume is bounded too: at most
        ``METRICS_MAX_ROWS`` rows per slave, ``METRICS_MAX_LABELS``
        labels per row, label values truncated — a GiB-sized hostile
        snapshot cannot balloon the master's memory or its scrapes."""
        from veles_tpu_torch.observe.metrics import (LABEL_NAME_RE,
                                               METRIC_NAME_RE)

        out = {}
        for slave in list(self.slaves.values()):
            rows = slave.metrics_rows
            if not isinstance(rows, list):
                continue
            clean = []
            for row in rows[:self.METRICS_MAX_ROWS]:
                try:
                    name, kind, labels, value = row
                    if not isinstance(name, str) \
                            or not METRIC_NAME_RE.match(name) \
                            or kind not in ("counter", "gauge") \
                            or isinstance(value, bool) \
                            or not isinstance(value, (int, float)) \
                            or len(labels) > self.METRICS_MAX_LABELS:
                        continue
                    keys = [str(k) for k, _ in labels]
                    if not all(LABEL_NAME_RE.match(k) and k != "slave"
                               for k in keys):
                        continue
                    clean.append((
                        name, kind,
                        {str(k): str(v)[:self.METRICS_MAX_VALUE_LEN]
                         for k, v in labels}, value))
                except (TypeError, ValueError):
                    continue
            if clean:
                out[slave.id] = clean
        return out

    def fleet_status(self):
        """Observability snapshot consumed by the web-status dashboard
        and the SlaveStats plotter (reference ``web_status.py`` feed).
        Called from the status/plotter threads while the event-loop
        thread mutates the roster — snapshot both containers first (as
        ``drain()`` does) instead of iterating them live."""
        slaves = list(self.slaves.values())
        pending = list(self._pending_requests)
        chaos = {}
        for counters in list(self._chaos_reports.values()):
            for key, value in counters.items():
                if isinstance(value, (int, float)):
                    chaos[key] = chaos.get(key, 0) + value
        ledger_snap = self.ledger.snapshot()
        slave_rows = [s.as_dict() for s in slaves]
        for row in slave_rows:
            # the fleetscope per-slave truth: median step time + the
            # straggler score vs the fleet median (one implementation
            # with the hang timeout — observe/fleetscope.py)
            stats = self.scope.slave_stats(row.get("id"))
            if stats:
                row.update(stats)
        status = {"slaves": slave_rows,
                  # .copy() is a single C-level op (GIL-atomic), unlike
                  # sorted() iterating the live set under a concurrent
                  # hang-check blacklist.add
                  "blacklist": sorted(self.blacklist.copy()),
                  "queued_jobs": len(pending),
                  "epoch": self.epoch,
                  "plane": self.plane,
                  "ledger": ledger_snap,
                  "chaos": chaos}
        goodput = self.scope.goodput_summary(
            wasted_s=ledger_snap.get("wasted_s", 0.0))
        if goodput["jobs"]:
            status["goodput"] = goodput
        straggler = self.scope.straggler_summary()
        if straggler is not None:
            status["straggler"] = straggler
        clocks = self.scope.clock_summary()
        if clocks:
            status["clock"] = clocks
        if self.control_plane:
            status["sync"] = dict(self._sync_counters)
            status["payload_rejects"] = self._payload_rejects
        reduce_rows = {sid: dict(entry) for sid, entry
                       in self._reduce_reports.copy().values()}
        if reduce_rows:
            status["reduce"] = reduce_rows
        return status

    def fleet_debug(self):
        """The ``GET /debug/fleet`` payload (docs/observability.md,
        "Fleet timeline + goodput"): everything ``veles_tpu_torch
        observe fleet-trace`` needs to assemble the merged, clock-aligned
        timeline — this process's flight-ring span events, the shipped
        slave spans mapped onto the master timeline, the per-process
        clock estimates, and the goodput/straggler status."""
        entries = get_flight_recorder().entries()
        return {
            "kind": "fleetscope",
            "schema": 1,
            "now_mono": time.monotonic(),
            "master_pid": os.getpid(),
            "master_mid": machine_id(),
            "status": self.fleet_status(),
            "clocks": self.scope.clock_summary(),
            "slave_spans": self.scope.span_rows(),
            "master_spans": [entry for entry in entries
                             if entry.get("kind") == "span"],
        }

    @staticmethod
    def _mine_reduce_rows(rows):
        """In-program-reduce stats from one piggybacked snapshot
        (``parallel/mapreduce.py`` publishes them into each slave's
        registry) — the web-status fleet column's proof the math
        stayed on the device."""
        entry = {}
        for row in rows:
            try:
                name, _, _, value = row
            except (TypeError, ValueError):
                continue
            if not isinstance(value, (int, float)) \
                    or isinstance(value, bool):
                continue
            if name == "veles_fleet_reduce_steps_total":
                entry["steps"] = entry.get("steps", 0) + value
            elif name == "veles_fleet_reduce_bytes_total":
                entry["bytes"] = entry.get("bytes", 0) + value
            elif name == "veles_fleet_chip_idle_fraction":
                entry["idle"] = value
        return entry
