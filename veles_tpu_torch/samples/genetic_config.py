"""Config for the port's GeneticExample: the two knobs the GA tunes."""

from veles_tpu_torch.genetics import Range

root.test.update({  # noqa: F821  (root is injected by the CLI)
    "x": Range(0.5, -1.0, 1.0),
    "y": Range(0.5, -1.0, 1.0),
})
