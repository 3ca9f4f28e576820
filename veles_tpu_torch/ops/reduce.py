"""Matrix reductions.

The port of ``veles_tpu/ops/reduce.py``: named entry points for the
reductions Znicz ran through its generic ``matrix_reduce`` kernels (bias
gradients, normalization statistics, the Kohonen winner search). They
are torch reductions on the tensor's own device.
"""


def reduce_sum(x, axis=0):
    return x.sum(dim=axis)


def reduce_mean(x, axis=0):
    """The sum times the f32 reciprocal of the count, as XLA lowers
    ``jnp.mean`` (so the two agree bit for bit)."""
    return x.sum(dim=axis) * (1.0 / x.shape[axis])


def reduce_max(x, axis=0):
    return x.amax(dim=axis)


def argmin_rows(x):
    """Winner search across rows (Kohonen SOM uses this shape)."""
    return x.argmin(dim=-1)
