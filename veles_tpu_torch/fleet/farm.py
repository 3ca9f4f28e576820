"""Task farm: distribute generic evaluation commands over the fleet.

The port's copy of ``veles_tpu/fleet/farm.py``.

The reference distributed genetics chromosome evaluations and ensemble
trainings to slaves through the same master/slave protocol as data-parallel
training (``genetics/optimization_workflow.py:179-279``,
``ensemble/base_workflow.py:101-127``) — each "job" was a full training
run. This module is that capability as a first-class adapter: a
:class:`TaskFarmMaster` speaks the fleet Server's workflow protocol
(generate/apply/drop/has_more_jobs) and serves **subprocess command**
tasks; a :class:`TaskFarmSlave` runs each command with a private
``--result-file`` and returns the parsed JSON as the update.

Lifecycle: ``submit()`` tasks (any time — between GA generations too),
``wait_batch()`` for the outstanding set, ``close()`` when no more will
ever come (lets idle slaves exit). Dropped slaves requeue their in-flight
tasks (same guarantee as the Loader's failed-minibatch path).
"""

import collections
import json
import os
import subprocess
import tempfile
import threading

from veles_tpu_torch.core.logger import Logger


class TaskFarmMaster(Logger):
    """Fleet-protocol task queue (master side)."""

    def __init__(self, name="task-farm"):
        super().__init__(logger_name="TaskFarmMaster")
        self.name = name
        self.checksum = "taskfarm:" + name
        self._lock = threading.Lock()
        self._pending = collections.deque()
        self._in_flight = {}  # slave_id -> {task_id: payload}
        self._results = {}
        self._outstanding = 0
        self._batch_done = threading.Event()
        self._batch_done.set()
        self._closed = False
        #: called after submit() — wire to Server.kick so backpressured
        #: slaves re-request immediately
        self.on_new_tasks = None

    # -- producer API ---------------------------------------------------------
    def submit(self, task_id, argv):
        with self._lock:
            if self._closed:
                raise RuntimeError("farm is closed")
            self._pending.append((task_id, list(argv)))
            self._outstanding += 1
            self._batch_done.clear()
        if self.on_new_tasks is not None:
            self.on_new_tasks()

    def wait_batch(self, timeout=None):
        """Block until every submitted task has a result. Returns the
        accumulated {task_id: result} map."""
        if not self._batch_done.wait(timeout):
            raise TimeoutError("task farm batch timed out")
        with self._lock:
            return dict(self._results)

    def take_results(self):
        with self._lock:
            results, self._results = self._results, {}
            return results

    def close(self):
        """No more submissions: idle slaves may exit."""
        with self._lock:
            self._closed = True

    # -- fleet workflow protocol ----------------------------------------------
    def generate_initial_data_for_slave(self, slave):
        return None

    def generate_data_for_slave(self, slave):
        with self._lock:
            if self._pending:
                task_id, argv = self._pending.popleft()
                self._in_flight.setdefault(slave.id, {})[task_id] = argv
                return {"task_id": task_id, "argv": argv}
            if self._closed and not self._outstanding:
                return None  # farm drained: slave exits
            return False  # backpressure: parked until kick()/next update

    def apply_data_from_slave(self, update, slave):
        task_id = update["task_id"]
        with self._lock:
            flight = self._in_flight.get(slave.id, {})
            if task_id in flight:
                del flight[task_id]
                self._outstanding -= 1
            self._results[task_id] = update
            if not self._outstanding:
                self._batch_done.set()

    def drop_slave(self, slave=None):
        slave_id = getattr(slave, "id", slave)
        with self._lock:
            flight = self._in_flight.pop(slave_id, {})
            for task_id, argv in flight.items():
                self._pending.appendleft((task_id, argv))
        if flight:
            self.warning("requeued %d tasks from dropped slave %s",
                         len(flight), slave_id)
            if self.on_new_tasks is not None:
                self.on_new_tasks()

    def has_more_jobs(self):
        with self._lock:
            return bool(self._pending or self._outstanding
                        or not self._closed)


class TaskFarmSlave(Logger):
    """Fleet-protocol task executor (slave side): each job is a command
    run as a subprocess with a private ``--result-file``."""

    def __init__(self, name="task-farm", env=None):
        super().__init__(logger_name="TaskFarmSlave")
        self.name = name
        self.checksum = "taskfarm:" + name
        self.env = env

    def apply_initial_data_from_master(self, initial):
        pass

    def do_job(self, job, callback):
        task_id, argv = job["task_id"], list(job["argv"])
        fd, result_file = tempfile.mkstemp(suffix=".json", prefix="farm_")
        os.close(fd)
        argv += ["--result-file", result_file]
        self.info("task %s: %s", task_id, " ".join(argv[:4]) + " ...")
        proc = subprocess.run(
            argv, env=self.env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        update = {"task_id": task_id, "rc": proc.returncode}
        try:
            with open(result_file) as fin:
                update["results"] = json.load(fin)
        except (OSError, ValueError) as exc:
            update["error"] = str(exc)
        finally:
            try:
                os.unlink(result_file)
            except OSError:
                pass
        callback(update)


def farm_worker(master_address, name="task-farm", power=1.0):
    """Run a farm slave against ``master_address`` (blocking). The
    reference slaves ran the same ``veles`` binary; here any host with
    the package can serve evaluations."""
    from veles_tpu_torch.fleet.client import Client
    client = Client(master_address, TaskFarmSlave(name), power=power)
    client.start()
    client.join()
    return client


def main(argv=None):  # pragma: no cover - manual entry point
    import argparse
    from veles_tpu_torch.core.logger import setup_logging
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.fleet.farm",
        description="join a task farm as an evaluation slave")
    parser.add_argument("master", help="master HOST:PORT")
    parser.add_argument("--name", default="task-farm")
    parser.add_argument("--power", type=float, default=1.0)
    args = parser.parse_args(argv)
    setup_logging()
    farm_worker(args.master, args.name, args.power)


if __name__ == "__main__":  # pragma: no cover
    main()
