"""Shell: drop into an interactive console mid-workflow.

The port of ``veles_tpu/interaction.py`` (reference
``veles/interaction.py:49-95``): the unit checks a trigger on each run
(a line ``i`` on a terminal's stdin, an explicit :meth:`Shell.interrupt`,
or the existence of ``trigger_path``, which works where stdin is
detached) and embeds a console with the workflow in scope; training
resumes when the console exits. IPython is imported only when a trigger
fires, and ``code.interact`` serves where it is absent.
"""

import os
import select
import sys

from veles_tpu_torch.core.units import Unit


class Shell(Unit):
    """Interactive breakpoint unit (reference ``Shell``,
    ``interaction.py:49``)."""

    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow, **kwargs):
        self.trigger_path = kwargs.pop("trigger_path", None)
        super().__init__(workflow, **kwargs)

    def init_unpickled(self):
        super().init_unpickled()
        self._interrupt_ = False

    def interrupt(self):
        """Programmatic trigger: the next run() opens the console."""
        self._interrupt_ = True

    def _stdin_triggered(self):
        if not sys.stdin or not sys.stdin.isatty():
            return False
        try:
            ready, _, _ = select.select([sys.stdin], [], [], 0)
        except (OSError, ValueError):
            return False
        if not ready:
            return False
        return sys.stdin.readline().strip().lower() == "i"

    def _file_triggered(self):
        if self.trigger_path and os.path.exists(self.trigger_path):
            os.unlink(self.trigger_path)
            return True
        return False

    def run(self):
        if not (self._interrupt_ or self._file_triggered()
                or self._stdin_triggered()):
            return
        self._interrupt_ = False
        self.info("dropping into the interactive shell "
                  "(exit to resume training)")
        self.embed()

    def embed(self):
        banner = ("veles_tpu_torch shell: workflow=%r; `workflow` and "
                  "`unit` are in scope" % self.workflow.name)
        try:
            import IPython
        except ImportError:
            import code
            code.interact(banner=banner,
                          local={"workflow": self.workflow, "unit": self})
            return
        IPython.embed(banner1=banner,
                      user_ns={"workflow": self.workflow, "unit": self})
