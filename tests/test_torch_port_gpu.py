"""The port's CUDA kernel on the card: K5 (packed-int4 decode matmul)
against its plain PyTorch version, the wrapper's input checks, and the
decode-shape routing of the int4 `QuantDense`.

Every test needs a CUDA GPU and skips without one. The file imports no
JAX, so it also runs where only PyTorch is installed, without the JAX
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

Tolerance: one bf16 ulp at the largest output, 2^-7 * max|plain|. Both
sides sum exact bf16 x int4 products in float32, in different orders.
"""

import pytest
import torch

from competesmoe_tpu_torch.models import decoder as tdec
from competesmoe_tpu_torch.ops import matvec as tmatvec

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _operands(g, m, k, n):
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randint(-8, 8, (k, n), generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-3
    return x, tdec.pack_int4(q), scale


def _assert_close(got, want):
    tol = 2.0 ** -7 * float(want.float().abs().max())
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float((got.float() - want.float()).abs().max()) <= tol


# decode projections of the 5.1B decoder, then the other row groupings
@pytest.mark.parametrize("m,k,n", [
    (1, 3072, 9216), (1, 3072, 3072), (1, 3072, 16384), (1, 8192, 3072),
    (2, 3072, 3072), (3, 1024, 256), (8, 8192, 3072), (40, 1024, 256),
    (128, 3072, 512)])
def test_int4_kernel_matches_plain(gen, m, k, n):
    x, w, scale = _operands(gen, m, k, n)
    before = tmatvec.quant_small_m_matmul_int4.launches
    got = tmatvec.quant_small_m_matmul_int4(x, w, scale)
    torch.cuda.synchronize()
    assert tmatvec.quant_small_m_matmul_int4.launches == before + 1
    _assert_close(got, tmatvec.quant_small_m_matmul_int4_reference(
        x, w, scale))


def test_int4_kernel_rejects_what_it_does_not_take(gen):
    x, w, scale = _operands(gen, 1, 1024, 256)
    with pytest.raises(TypeError):
        tmatvec.quant_small_m_matmul_int4(x.float(), w, scale)
    with pytest.raises(ValueError):
        tmatvec.quant_small_m_matmul_int4(x, w.t().contiguous().t(), scale)
    with pytest.raises(ValueError):
        tmatvec.quant_small_m_matmul_int4(x[:, :512], w, scale)
    with pytest.raises(ValueError):
        tmatvec.quant_small_m_matmul_int4(x, w, scale.cpu())


def test_quant_dense_sends_decode_shapes_to_the_kernel(gen):
    """int4 QuantDense on the card: decode rows (M <= 128) launch K5,
    prefill rows (M > 128) take the plain halves contraction; both agree
    with the same layer on the CPU."""
    layer = tdec.QuantDense(1024, 512, mode="int4", device="cuda")
    _, w, scale = _operands(gen, 1, 1024, 512)
    layer.kernel_q.copy_(w)
    layer.scale.copy_(scale)
    cpu = tdec.QuantDense(1024, 512, mode="int4", device="cpu")
    cpu.load_state_dict(layer.state_dict())
    for rows, launched in ((1, 1), (8, 1), (319, 0)):
        x = torch.randn(1, rows, 1024, generator=gen,
                        device="cuda").to(torch.bfloat16)
        before = tmatvec.quant_small_m_matmul_int4.launches
        with torch.no_grad():
            got = layer(x)
            want = cpu(x.cpu())
        torch.cuda.synchronize()
        assert (tmatvec.quant_small_m_matmul_int4.launches - before
                == launched)
        _assert_close(got.cpu(), want)
