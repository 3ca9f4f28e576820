"""Plumbing units: StartPoint, EndPoint, Repeater, FireStarter.

Equivalents of reference ``veles/plumbing.py``.
"""

from veles_tpu_torch.core.units import TrivialUnit, Unit


class Repeater(TrivialUnit):
    """Closes the epoch loop: ignores its gate so the cycle re-fires every
    tick (reference ``plumbing.py:17``)."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Repeater")
        super().__init__(workflow, **kwargs)
        self.ignores_gate <<= True


class StartPoint(TrivialUnit):
    """Workflow entry node (reference ``plumbing.py:44``)."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Start")
        super().__init__(workflow, **kwargs)


class EndPoint(TrivialUnit):
    """Workflow exit node: running it finishes the workflow (reference
    ``plumbing.py:80-88``). In fleet mode on the master, the EndPoint never
    *runs* — instead its ``apply_data_from_slave`` fires when the job stream
    is exhausted, finishing the master workflow."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "End")
        super().__init__(workflow, **kwargs)

    def run(self):
        self.workflow.on_workflow_finished()

    def generate_data_for_master(self):
        return True

    def apply_data_from_slave(self, data, slave=None):
        # master: a slave hit its EndPoint; if there are no more jobs the
        # master workflow is finished (reference plumbing.py:86-88)
        if not self.workflow.has_more_jobs():
            self.workflow.on_workflow_finished()


class FireStarter(Unit):
    """Resets ``stopped`` on its target units so a finished sub-graph can be
    re-armed (reference ``plumbing.py:92``)."""

    def __init__(self, workflow, units=(), **kwargs):
        super().__init__(workflow, **kwargs)
        self.units = list(units)

    def run(self):
        for unit in self.units:
            unit.stopped = False
