"""The port's W8A16 tier (veles_tpu_torch/ops/quant.py) against the JAX
package's (veles_tpu/ops/quant.py) on the same numpy inputs.

On the CPU the port's int8_matmul runs its plain version; the JAX side
runs both its XLA formulation and its Pallas kernel in interpret mode.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.ops import quant as jquant
from veles_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

#: f32 products over K <= 64 terms of |x| ~ 1 and |w| <= 127 scaled by
#: ~1e-2: reordered sums differ by a few ulp of values ~10, far below
ATOL = 1e-5


def _weights(k, n, seed=0):
    w = numpy.random.RandomState(seed).randn(k, n).astype(numpy.float32)
    w[:, 3] = 0.0   # a zero column gets scale 1 and q 0
    return w


def test_quantize_int8_matches_jax():
    w = _weights(48, 40)
    jq, js = jquant.quantize_int8(jnp.asarray(w))
    tq, ts = tquant.quantize_int8(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    numpy.testing.assert_array_equal(tq.numpy(), numpy.asarray(jq))
    # one f32 division either side: the scales agree to the last ulp
    numpy.testing.assert_allclose(ts.numpy(), numpy.asarray(js),
                                  rtol=1e-7, atol=0)
    assert ts[3].item() == 1.0 and not tq[:, 3].any()


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "pallas-interpret"])
def test_plain_int8_matmul_matches_jax(use_pallas):
    # K % 32 == 0 and N % 512 == 0: the shapes the Pallas kernel takes
    k, n, m = 64, 512, 5
    q, s = jquant.quantize_int8(jnp.asarray(_weights(k, n)))
    x = numpy.random.RandomState(1).randn(m, k).astype(numpy.float32)
    ref = jquant.int8_matmul(jnp.asarray(x), q, s, use_pallas=use_pallas,
                             interpret=True)
    out = tquant.int8_matmul(torch.from_numpy(x),
                             torch.from_numpy(numpy.array(q)),
                             torch.from_numpy(numpy.array(s)))
    assert out.dtype == torch.float32 and out.shape == (m, n)
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATOL, rtol=0)


def test_large_product_matches_jax_xla():
    """Above PALLAS_MAX_ROWS the regime rule picks the dequantized
    product, in both packages."""
    k, n, m = 32, 24, tquant.PALLAS_MAX_ROWS + 44
    q, s = jquant.quantize_int8(jnp.asarray(_weights(k, n)))
    x = numpy.random.RandomState(2).randn(m, k).astype(numpy.float32)
    ref = jquant.int8_matmul(jnp.asarray(x), q, s, use_pallas=False)
    out = tquant.int8_matmul(torch.from_numpy(x),
                             torch.from_numpy(numpy.array(q)),
                             torch.from_numpy(numpy.array(s)))
    numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                  atol=ATOL, rtol=0)


def test_bf16_activations_keep_their_type():
    """W8A16 in bf16: the same f32 accumulation, one rounding to bf16 at
    the end (2^-8 relative)."""
    k, n, m = 64, 40, 3
    q, s = tquant.quantize_int8(torch.from_numpy(_weights(k, n)))
    x = torch.from_numpy(
        numpy.random.RandomState(3).randn(m, k).astype(numpy.float32))
    out = tquant.int8_matmul(x.bfloat16(), q, s)
    assert out.dtype == torch.bfloat16
    ref = (x.bfloat16().float() @ q.float()) * s
    numpy.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                                  rtol=2 ** -8, atol=1e-6)


def test_matmul_any_routes_dense_and_quantized():
    w = _weights(16, 12)
    x = numpy.random.RandomState(4).randn(2, 3, 16).astype(numpy.float32)
    q, s = jquant.quantize_int8(jnp.asarray(w))
    for jw, tw in ((jnp.asarray(w), torch.from_numpy(w)),
                   ({"q8": q, "scale": s},
                    {"q8": torch.from_numpy(numpy.array(q)),
                     "scale": torch.from_numpy(numpy.array(s))})):
        ref = jquant.matmul_any(jnp.asarray(x), jw)
        out = tquant.matmul_any(torch.from_numpy(x), tw)
        assert out.shape == (2, 3, 12)
        numpy.testing.assert_allclose(out.numpy(), numpy.asarray(ref),
                                      atol=ATOL, rtol=0)


def test_cpu_tensors_never_count_a_launch():
    q, s = tquant.quantize_int8(torch.randn(8, 8))
    before = tquant.int8_matmul.launches
    tquant.int8_matmul(torch.randn(2, 8), q, s)
    assert tquant.int8_matmul.launches == before


@pytest.mark.parametrize("case", ["x_rank", "k_mismatch", "x_dtype",
                                  "q_dtype", "scale_dtype", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x = torch.randn(2, 8)
    q, s = tquant.quantize_int8(torch.randn(8, 4))
    bad = {"x_rank": (x[None], q, s),
           "k_mismatch": (torch.randn(2, 7), q, s),
           "x_dtype": (x.double(), q, s),
           "q_dtype": (x, q.to(torch.int16), s),
           "scale_dtype": (x, q, s.double()),
           "empty": (torch.randn(0, 8), q, s)}[case]
    with pytest.raises((ValueError, TypeError)):
        tquant.int8_matmul(*bad)
