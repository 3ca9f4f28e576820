"""Device random number generation.

The port of ``veles_tpu/ops/rng.py``: where the JAX functions take a
threefry key, these take a ``torch.Generator``, whose device the draws
land on. The two streams do not cross: the same seed gives other
numbers in the two packages (only shapes, dtypes and ranges agree).
"""

import torch


def uniform(generator, shape, dtype=torch.float32, low=-1.0, high=1.0):
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.uniform_(low, high, generator=generator)


def normal(generator, shape, dtype=torch.float32, mean=0.0, stddev=1.0):
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.normal_(mean, stddev, generator=generator)


def fill_uniform(generator, shape, vle, dtype=torch.float32):
    """Znicz-style symmetric init: U(-vle, vle)."""
    return uniform(generator, shape, dtype, -vle, vle)
