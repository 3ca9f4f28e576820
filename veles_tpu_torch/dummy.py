"""Test fixtures: fake launcher/workflow so any unit can be unit-tested
without networking or a real launcher (reference ``veles/dummy.py:46-131``).
"""

from veles_tpu_torch.core.executor import ThreadPool
from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.core.workflow import Workflow


class DummyLauncher(Logger):
    """Reports standalone mode and hosts a thread pool — nothing else."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._units = []
        self.thread_pool = ThreadPool(name="dummy")
        self.stopped = False

    @property
    def is_master(self):
        return False

    @property
    def is_slave(self):
        return False

    @property
    def is_standalone(self):
        return True

    def add_ref(self, unit):
        self._units.append(unit)

    def del_ref(self, unit):
        if unit in self._units:
            self._units.remove(unit)

    def on_workflow_finished(self):
        pass

    def stop(self):
        self.thread_pool.shutdown()


class DummyWorkflow(Workflow):
    """A Workflow parented to a fresh DummyLauncher."""

    def __init__(self, **kwargs):
        super().__init__(DummyLauncher(), **kwargs)
