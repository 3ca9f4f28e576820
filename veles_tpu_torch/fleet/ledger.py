"""Job ledger: per-job leases, explicit requeue, exactly-once fencing.

The port's copy of ``veles_tpu/fleet/ledger.py``.

The reference fleet recovered a dead slave's in-flight minibatch only as a
side effect of ``drop_slave`` (``server.py:619-655``) and applied whatever
update a slave shipped, unfenced. The ledger makes job-level accounting
explicit:

- every job served gets a monotonically increasing ``job_id`` and a
  *lease* whose deadline derives from the slave's adaptive timeout
  (mean + 3 sigma of its job history, ``SlaveDescription.timeout``);
- the master records every transition — OUTSTANDING -> DONE (update
  applied) or OUTSTANDING -> REQUEUED (lease expired, or the slave
  dropped with the job in flight);
- an incoming update is *fenced* (rejected with a warning, never applied)
  when its ``job_id`` is unknown, already applied (duplicate replay),
  already requeued (a hung slave's late answer — the work was re-served
  to someone else), owned by a different slave, or stamped with a
  previous master *epoch* (master restart; see ``Server.epoch``).

This is the master/slave analogue of DrJAX's point (PAPERS.md) that
data-parallel aggregation needs well-specified semantics: the ledger pins
``apply_data_from_slave`` to exactly-once-per-lease.

Thread safety: the asyncio event-loop thread issues/settles leases while
the status thread (web dashboard, SlaveStats plotter) reads ``snapshot()``
— every public method takes the internal lock.
"""

import collections
import threading
import time

OUTSTANDING = "OUTSTANDING"
DONE = "DONE"
REQUEUED = "REQUEUED"

#: settle() verdicts that mean "reject, do not apply"
FENCE_UNKNOWN = "unknown-job"
FENCE_DUPLICATE = "duplicate"
FENCE_REQUEUED = "requeued"
FENCE_FOREIGN = "foreign-slave"
FENCE_STALE_EPOCH = "stale-epoch"


class JobLease:
    """One served job's accounting record."""

    __slots__ = ("job_id", "sid", "issued_at", "deadline", "state")

    def __init__(self, job_id, sid, deadline, now):
        self.job_id = job_id
        self.sid = sid
        self.issued_at = now
        self.deadline = deadline
        self.state = OUTSTANDING


class JobLedger:
    """The master's job-accounting table.

    Settled (DONE/REQUEUED) leases are garbage-collected beyond
    ``keep_settled`` entries; a ``job_id`` below the GC watermark that is
    no longer in the table is by construction settled, so its update is
    fenced as a duplicate — never misread as unknown-and-applicable.
    """

    def __init__(self, keep_settled=10000):
        self._lock = threading.Lock()
        self._leases = {}
        self._next_id = 0
        self._watermark = 0  # ids <= watermark and absent => settled+GC'd
        self._keep_settled = keep_settled
        self._settled_order = collections.deque()  # GC queue, oldest left
        self.counters = {
            "issued": 0, "done": 0,
            "requeued_dropped": 0, "requeued_expired": 0,
        }
        #: wasted-work accounting (observe/fleetscope.py goodput): the
        #: in-flight seconds of every lease that was REQUEUED — work a
        #: slave (probably) did whose result was discarded and re-run
        #: elsewhere (requeued-after-death / hang-expired)
        self.wasted_seconds = 0.0
        self.fenced = {
            FENCE_UNKNOWN: 0, FENCE_DUPLICATE: 0, FENCE_REQUEUED: 0,
            FENCE_FOREIGN: 0, FENCE_STALE_EPOCH: 0,
        }

    # -- lease lifecycle ------------------------------------------------------
    def issue(self, sid, timeout, now=None):
        """Record a new OUTSTANDING lease; returns its ``job_id``."""
        now = time.time() if now is None else now
        with self._lock:
            self._next_id += 1
            job_id = self._next_id
            self._leases[job_id] = JobLease(job_id, sid, now + timeout, now)
            self.counters["issued"] += 1
            return job_id

    def settle(self, job_id, sid):
        """Judge an incoming update. Returns ``None`` when the update must
        be applied (lease was OUTSTANDING for this slave -> now DONE), or a
        FENCE_* verdict string when it must be rejected."""
        with self._lock:
            if not isinstance(job_id, int):
                self.fenced[FENCE_UNKNOWN] += 1
                return FENCE_UNKNOWN
            lease = self._leases.get(job_id)
            if lease is None:
                verdict = (FENCE_DUPLICATE
                           if 0 < job_id <= self._watermark
                           else FENCE_UNKNOWN)
                self.fenced[verdict] += 1
                return verdict
            if lease.sid != sid:
                self.fenced[FENCE_FOREIGN] += 1
                return FENCE_FOREIGN
            if lease.state == DONE:
                self.fenced[FENCE_DUPLICATE] += 1
                return FENCE_DUPLICATE
            if lease.state == REQUEUED:
                self.fenced[FENCE_REQUEUED] += 1
                return FENCE_REQUEUED
            lease.state = DONE
            self.counters["done"] += 1
            self._retire(job_id)
            return None

    def count_stale_epoch(self):
        with self._lock:
            self.fenced[FENCE_STALE_EPOCH] += 1
        return FENCE_STALE_EPOCH

    def requeue_for_slave(self, sid, now=None):
        """Mark every OUTSTANDING lease of a dropped slave REQUEUED (the
        Loader requeues the actual minibatches via ``drop_slave``; this
        records the transition and arms the fence against a zombie's late
        updates). Returns the requeued job ids."""
        now = time.time() if now is None else now
        with self._lock:
            requeued = []
            # snapshot: _retire's GC pops settled leases from the same
            # dict once the backlog passes keep_settled
            for lease in list(self._leases.values()):
                if lease.sid == sid and lease.state == OUTSTANDING:
                    lease.state = REQUEUED
                    self.counters["requeued_dropped"] += 1
                    self.wasted_seconds += max(0.0,
                                               now - lease.issued_at)
                    self._retire(lease.job_id)
                    requeued.append(lease.job_id)
            return requeued

    def expire_if_outstanding(self, job_id, now=None):
        """Hang check: when the lease is still OUTSTANDING past its
        deadline, mark it REQUEUED and return True (the caller drops the
        slave, which requeues the minibatch)."""
        now = time.time() if now is None else now
        with self._lock:
            lease = self._leases.get(job_id)
            if lease is None or lease.state != OUTSTANDING \
                    or now <= lease.deadline:
                return False
            lease.state = REQUEUED
            self.counters["requeued_expired"] += 1
            self.wasted_seconds += max(0.0, now - lease.issued_at)
            self._retire(job_id)
            return True

    def outstanding(self, sid=None):
        with self._lock:
            return [lease.job_id for lease in self._leases.values()
                    if lease.state == OUTSTANDING
                    and (sid is None or lease.sid == sid)]

    def state_of(self, job_id):
        with self._lock:
            lease = self._leases.get(job_id)
            if lease is not None:
                return lease.state
            # tolerate wire garbage like settle() does
            if isinstance(job_id, int) and 0 < job_id <= self._watermark:
                return DONE
            return None

    # -- observability --------------------------------------------------------
    def snapshot(self):
        """Status dict for ``fleet_status()`` / the web dashboard."""
        with self._lock:
            outstanding = sum(1 for lease in self._leases.values()
                              if lease.state == OUTSTANDING)
            return {
                "issued": self.counters["issued"],
                "done": self.counters["done"],
                "outstanding": outstanding,
                "requeued": (self.counters["requeued_dropped"]
                             + self.counters["requeued_expired"]),
                "requeued_dropped": self.counters["requeued_dropped"],
                "requeued_expired": self.counters["requeued_expired"],
                "wasted_s": round(self.wasted_seconds, 3),
                "fenced": dict(self.fenced),
                "fenced_total": sum(self.fenced.values()),
            }

    # -- internals ------------------------------------------------------------
    def _retire(self, job_id):
        """Queue a settled lease for GC; advance the watermark once the
        settled backlog exceeds ``keep_settled``. Lock held by caller."""
        self._settled_order.append(job_id)
        while len(self._settled_order) > self._keep_settled:
            old = self._settled_order.popleft()
            self._leases.pop(old, None)
            if old > self._watermark:
                self._watermark = old
