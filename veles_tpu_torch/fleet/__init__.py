"""veles_tpu_torch.fleet: elastic host-level distribution (master/slave).

The port of ``veles_tpu/fleet/``: the wire (``protocol.py``,
``safecodec.py``, ``sharedio.py``), the job ledger, the chaos harness,
the master (``server.py``), the slave (``client.py``), respawn and the
task farm. Its frames are the JAX package's byte for byte. On the port
the slave's job runs the fused tick on its device (K6 forward and K5
backward where the engine knobs allow, ``models/standard.py``); the
payloads hold numpy arrays, which the units turn back into tensors on
their device. A slave whose own mesh spans several ranks (the fleet x
pod composition, ``pod.py``) is a ``torch.distributed`` world: its rank 0
speaks the wire and hands each event on to the other ranks, which step
the same meshed tick.

The reference's distributed runtime (SURVEY §2.5) is a master/slave
data-parallel protocol: the master owns canonical state and serves *jobs*
(per-unit payloads — for the Loader just minibatch indices); each slave
runs the whole workflow on its job and returns an *update*, merged into
master state. Asynchronous by default (stale updates accepted), elastic
(slaves join/leave any time, their pending work is requeued), with hang
detection and fault injection.

Inside one host, synchronous data parallelism (``parallel/``) is
the idiomatic path. Fleet mode exists for what collectives can't do —
dynamic/heterogeneous clusters over DCN, genetics/ensemble population
parallelism, and parity with the reference's elasticity semantics. The
transport is asyncio TCP with length-prefixed pickled frames (the modern
stdlib equivalent of the reference's Twisted control plane + ZeroMQ
streaming-pickle data plane, reference ``txzmq/connection.py:395-562``).

Fault tolerance (docs/fleet_robustness.md): every served job is a
*leased* ledger entry (``ledger.py``) — expired or dropped leases are
requeued explicitly and duplicate/stale/foreign updates are fenced,
with the master's per-start ``epoch`` UUID fencing across restarts. The
deterministic chaos harness (``chaos.py``) injects frame delay/drop,
stragglers, duplicate replay and mid-job death from one seeded RNG
stream so recovery is testable bit-for-bit.

Wire planes (``root.common.fleet.plane``, docs/compiler_fleet.md):

- ``data`` (default) — the reference protocol: jobs carry master
  weights, updates carry trained weights, the master merges host-side.
  Per-minibatch durability; the device idles through every merge.
- ``control`` — the compiler-visible refit: jobs carry batch
  *assignments* + epoch fences (plus learning rates), updates carry
  scalar metrics, and the parameter math stays in the slave's fused
  tick, its parameters resident on the device between epoch fences. Weights
  cross the wire only in the handshake (initial state) and at epoch
  fences (the ``sync`` frame). The ledger/lease/fencing/chaos/respawn
  machinery is identical in both planes.
"""


def fleet_control_plane():
    """True when the fleet runs the control-plane-only wire protocol
    (``root.common.fleet.plane = "control"``). Validates the knob."""
    from veles_tpu_torch.core.config import root
    plane = root.common.fleet.get("plane", "data")
    if plane not in ("data", "control"):
        raise ValueError(
            "root.common.fleet.plane / --fleet-plane must be 'data' or "
            "'control', got %r" % (plane,))
    return plane == "control"


def fleet_plane():
    """The configured plane name ("data"/"control"), validated."""
    return "control" if fleet_control_plane() else "data"


from veles_tpu_torch.fleet.server import Server  # noqa: F401,E402
from veles_tpu_torch.fleet.client import Client  # noqa: F401,E402
from veles_tpu_torch.fleet.ledger import JobLedger  # noqa: F401,E402
from veles_tpu_torch.fleet.chaos import (  # noqa: F401,E402
    ChaosConfig, ChaosMonkey)
