"""Kohonen SOM workflow.

The port of ``veles_tpu/models/kohonen.py``. Topology: Repeater → Loader
→ KohonenTrainer → epoch gate → (loop | End). Unsupervised: no evaluator
or GD chain; the workflow stops after its epoch budget and publishes the
quantization error as its result metric. ``device=None`` means "cuda"
and raises without a card unless the caller passes ``device="cpu"``.
"""

from veles_tpu_torch.core.mutable import Bool
from veles_tpu_torch.core.plumbing import Repeater
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.core.workflow import Workflow
from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.nn.kohonen import KohonenTrainer


class EpochLimiter(Unit):
    """Set ``complete`` after the loader finishes ``max_epochs``."""

    hide_from_registry = True

    def __init__(self, workflow, max_epochs=10, **kwargs):
        super().__init__(workflow, **kwargs)
        self.max_epochs = max_epochs
        self.complete = Bool(False)
        self.epochs_done = 0
        self.demand("epoch_ended")

    def run(self):
        if self.epoch_ended:
            self.epochs_done += 1
            if self.epochs_done >= self.max_epochs:
                self.info("stopping after %d epochs", self.epochs_done)
                self.complete.set(True)

    def get_metric_names(self):
        return ["epochs"]

    def get_metric_values(self):
        return [self.epochs_done]


class KohonenWorkflow(Workflow):
    """Self-organizing-map training workflow."""

    def __init__(self, workflow, shape=(8, 8), loader_kwargs=None,
                 trainer_kwargs=None, max_epochs=10, device=None,
                 **kwargs):
        self.device = resolve_device(device)
        super().__init__(workflow, **kwargs)
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)
        self.loader = FullBatchLoader(self, **(loader_kwargs or {}))
        self.loader.link_from(self.repeater)
        self.trainer = KohonenTrainer(self, shape=shape,
                                      **(trainer_kwargs or {}))
        self.trainer.link_attrs(self.loader, ("input", "minibatch_data"))
        self.trainer.link_from(self.loader)
        self.limiter = EpochLimiter(self, max_epochs=max_epochs)
        self.limiter.link_attrs(self.loader, "epoch_ended")
        self.limiter.link_from(self.trainer)
        self.repeater.link_from(self.limiter)
        self.end_point.link_from(self.limiter)
        self.end_point.gate_block = ~self.limiter.complete
        self.loader.gate_block = self.limiter.complete
        self.loader.complete = self.limiter.complete
