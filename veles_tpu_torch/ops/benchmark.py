"""Device benchmark: the computing-power measurement.

The port of ``veles_tpu/ops/benchmark.py`` (reference
``accelerated_units.py:706-824``, DeviceBenchmark): time a standard GEMM
workload and report ``1000/dt`` arbitrary "power" units, the number a
slave sends in its fleet handshake so the master can weight job balancing
by power (``workflow.py:613-619``). The workload is a chain of bfloat16
``torch.matmul`` products, as the JAX package's is ``jnp.matmul`` (no
kernel of this repository), on the card unless the caller names the CPU.
"""

import time

import torch

from veles_tpu_torch.device import resolve_device


def device_benchmark(size=1024, depth=4, iters=3, device=None):
    """Measured power of ``device`` (None means the card; raises without
    one) in the reference's 1000/dt units: ``depth`` chained (size,
    size) bf16 products, each result scaled by 1/size, one warm-up run,
    then the mean of ``iters`` runs fenced by ``torch.cuda.synchronize``
    on the card."""
    device = resolve_device(device)

    def chain(x):
        for _ in range(depth):
            x = torch.matmul(x, x) / size
        return x

    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    x = torch.ones((size, size), dtype=torch.bfloat16, device=device)
    chain(x)  # the first call's set-up stays outside the timing
    fence()
    t0 = time.perf_counter()
    for _ in range(iters):
        chain(x)
    fence()
    dt = (time.perf_counter() - t0) / iters
    return 1000.0 / max(dt, 1e-9)
