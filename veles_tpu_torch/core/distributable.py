"""Distributable contract: what a unit must provide to run in fleet mode.

Equivalent of reference ``veles/distributable.py:136-302``. The
``IDistributable`` contract (reference ``distributable.py:222-281``) is the
master/slave data exchange protocol every unit participates in when a
workflow runs distributed:

- ``generate_data_for_slave(slave)``: master → payload shipped in a job.
- ``apply_data_from_master(data)``: slave applies its job payload.
- ``generate_data_for_master()``: slave → payload shipped in an update.
- ``apply_data_from_slave(data, slave)``: master merges an update.
- ``drop_slave(slave)``: slave died; requeue its outstanding work.
- ``negotiates_on_connect``: take part in the initial handshake exchange.

Instead of zope interfaces + lock-wrapping with deadlock alarms (reference
``distributable.py:139-157``), the contract here is an ABC-free duck-typed
mixin with an RLock guarding master-side mutation and a configurable
acquisition timeout that logs suspected deadlocks.
"""

import threading

from veles_tpu_torch.core.pickling import Pickleable

DEADLOCK_TIMEOUT = 4.0  # seconds, mirrors reference distributable.py:139


class Distributable(Pickleable):
    """Base adding thread-safe master-side application of slave data."""

    negotiates_on_connect = False

    def __init__(self, **kwargs):
        self._data_lock_ = threading.RLock()
        self._data_event_ = threading.Event()
        self._data_event_.set()
        super().__init__(**kwargs)

    def init_unpickled(self):
        super().init_unpickled()
        self._data_lock_ = threading.RLock()
        self._data_event_ = threading.Event()
        self._data_event_.set()

    @property
    def has_data_for_slave(self):
        """Backpressure flag: False answers to job requests are queued and
        retried after the next update (reference
        ``distributable.py:189-205``, ``server.py:369-399``)."""
        return True

    def lock_data(self):
        if not self._data_lock_.acquire(timeout=DEADLOCK_TIMEOUT):
            self.warning("Possible deadlock in %s", self)
            self._data_lock_.acquire()

    def unlock_data(self):
        self._data_lock_.release()

    # -- IDistributable default (trivial) implementation --------------------
    # (reference TriviallyDistributable, distributable.py:284)
    def generate_data_for_master(self):
        return None

    def generate_data_for_slave(self, slave=None):
        return None

    def apply_data_from_master(self, data):
        pass

    def apply_data_from_slave(self, data, slave=None):
        pass

    def drop_slave(self, slave=None):
        pass

    # -- control-plane fleet extensions (docs/compiler_fleet.md) -------------
    # Optional hooks with safe defaults: the handshake payload (shipped
    # ONCE at connect — in control-plane mode the per-job wire omits
    # weights, so initial state must travel here) and the epoch-fence
    # bulk sync (slave -> master weight checkpoint, applied by
    # overwrite — the slave replica is canonical between fences).
    def generate_handshake_data(self, slave=None):
        return self.generate_data_for_slave(slave)

    def generate_sync_for_master(self):
        return None

    def apply_sync_from_slave(self, data, slave=None):
        pass


TriviallyDistributable = Distributable
