"""fairdiff_torch CUDA kernels against their plain PyTorch versions on the
card, at small and ragged shapes. Marked `gpu`: they skip where there is no
CUDA device (a CUDA kernel has no CPU or interpret mode) and run on the
card with `python -m pytest tests/test_torch_kernels_gpu.py -m gpu`.

Tolerances: fp32 kernels vs the fp64 plain version differ in summation
order only (1e-5; 1e-4 for the backward kernels, whose outputs are sums of
S*T products of exponentials). bf16 kernels vs the bf16 plain version differ by bf16
rounding noise (~2e-3 of the output's scale), so the limits are set against
that scale: every element within 0.1 * rms(plain) + 1e-2 * |plain|, rel L2
within 1e-2 (a kernel that drops a 64-key or 32-deep tile moves the output
by 1e-1 or more), and the kernel's rel L2 error against the fp64 version at
most 1.5 times the plain bf16 version's.
"""

import pytest
import torch

from fairdiff_torch.ops import flash_attention as fa
from fairdiff_torch.ops import geglu as gg

pytestmark = pytest.mark.gpu

F32_TOL = dict(atol=1e-5, rtol=1e-5)


def assert_matches(got, plain, exact, f32_tol=F32_TOL):
    """`got` (kernel) against `plain` (same type) and the fp64 `exact`."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got.float(), exact.float(), **f32_tol)
        return
    g, p = got.double(), plain.double()
    rms = p.pow(2).mean().sqrt()
    worst = ((g - p).abs() / (0.1 * rms + 1e-2 * p.abs())).max().item()
    assert worst <= 1.0, f"an element is off by {worst:.2f} of its limit"
    assert ((g - p).norm() / p.norm()).item() <= 1e-2
    assert (g - exact).norm().item() <= 1.5 * (p - exact).norm().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,h,d", [(600, 300, 2, 40), (77, 1030, 3, 80), (5, 64, 1, 16), (130, 200, 2, 128), (33, 70, 2, 20)])
def test_flash_kernel_matches_plain(cuda, dtype, s, t, h, d):
    q = torch.randn(2, s, h, d, generator=cuda, device="cuda", dtype=dtype)
    k = torch.randn(2, t, h, d, generator=cuda, device="cuda", dtype=dtype)
    v = torch.randn(2, t, h, d, generator=cuda, device="cuda", dtype=dtype)
    before = fa.launches
    got = fa.flash_attention(q, k, v)
    assert fa.launches == before + 1
    exact = fa.flash_attention_plain(q.double(), k.double(), v.double())
    assert_matches(got, fa.flash_attention_plain(q, k, v), exact)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,inner", [(37, 24, 100), (1000, 320, 1280), (64, 1280, 5120), (3, 48, 64), (130, 16, 33)])
def test_geglu_kernel_matches_plain(cuda, dtype, m, d, inner):
    x = torch.randn(m, d, generator=cuda, device="cuda").to(dtype)
    w = (torch.randn(2 * inner, d, generator=cuda, device="cuda") * d**-0.5).to(dtype)
    b = (torch.randn(2 * inner, generator=cuda, device="cuda") * 0.1).to(dtype)
    before = gg.launches
    got = gg.geglu(x, w, b)
    assert gg.launches == before + 1
    exact = gg.geglu_plain(x.double(), w.double(), b.double())
    assert_matches(got, gg.geglu_plain(x, w, b), exact)


def test_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.randn(1, 8, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q[:, ::2], q[:, ::2], q[:, ::2])
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="16-byte rows"):
        gg.geglu(torch.zeros(4, 12, device="cuda", dtype=torch.bfloat16),
                 torch.zeros(16, 12, device="cuda", dtype=torch.bfloat16),
                 torch.zeros(16, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        gg.geglu(torch.zeros(4, 8, device="cuda", dtype=torch.float16),
                 torch.zeros(16, 8, device="cuda", dtype=torch.float16),
                 torch.zeros(16, device="cuda", dtype=torch.float16))


FLASH_SHAPES = [(600, 300, 2, 40), (77, 1030, 3, 80), (5, 64, 1, 16), (130, 200, 2, 128), (33, 70, 2, 20)]


def _qkv_do(cuda, dtype, s, t, h, d):
    mk = lambda n: torch.randn(2, n, h, d, generator=cuda, device="cuda", dtype=dtype)
    return mk(s), mk(t), mk(t), mk(s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,h,d", FLASH_SHAPES)
def test_flash_lse_kernel_matches_plain(cuda, dtype, s, t, h, d):
    q, k, v, _ = _qkv_do(cuda, dtype, s, t, h, d)
    before = fa.launches_lse
    o, lse = fa.flash_attention_lse(q, k, v)
    assert fa.launches_lse == before + 1 and lse.shape == (2, h, s) and lse.dtype == torch.float32
    o_exact, lse_exact = fa.flash_attention_lse_plain(q.double(), k.double(), v.double())
    o_plain, lse_plain = fa.flash_attention_lse_plain(q, k, v)
    assert_matches(o, o_plain, o_exact)
    # lse is fp32 from the fp32 scores of the same (rounded) inputs in both
    torch.testing.assert_close(lse.double(), lse_exact, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,h,d", FLASH_SHAPES)
def test_flash_bwd_kernels_match_plain(cuda, dtype, s, t, h, d):
    q, k, v, do = _qkv_do(cuda, dtype, s, t, h, d)
    o, lse = fa.flash_attention_lse(q, k, v)
    before = (fa.launches_dq, fa.launches_dkv)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert (fa.launches_dq, fa.launches_dkv) == (before[0] + 1, before[1] + 1)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    o_exact, lse_exact = fa.flash_attention_lse_plain(qd, kd, vd)
    exact = fa.flash_attention_bwd_plain(qd, kd, vd, o_exact, lse_exact, dod)
    for g, p_, e in zip(got, plain, exact):
        assert_matches(g, p_, e, f32_tol=dict(atol=1e-4, rtol=1e-4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,inner", [(37, 24, 100), (1000, 320, 1280), (64, 1280, 5120), (3, 48, 64), (130, 16, 33), (300, 640, 2560)])
def test_geglu_dx_kernel_matches_plain(cuda, dtype, m, d, inner):
    x = torch.randn(m, d, generator=cuda, device="cuda").to(dtype)
    w = (torch.randn(2 * inner, d, generator=cuda, device="cuda") * d**-0.5).to(dtype)
    b = (torch.randn(2 * inner, generator=cuda, device="cuda") * 0.1).to(dtype)
    dy = torch.randn(m, inner, generator=cuda, device="cuda").to(dtype)
    before = gg.launches_dx
    got = gg.geglu_dx(x, w, b, dy)
    assert gg.launches_dx == before + 1
    exact = gg.geglu_dx_plain(x.double(), w.double(), b.double(), dy.double())
    assert_matches(got, gg.geglu_dx_plain(x, w, b, dy), exact, f32_tol=dict(atol=1e-4, rtol=1e-4))


def test_functions_carry_gradients_on_the_card(cuda):
    """On CUDA tensors that need a gradient the entry points go through the
    autograd Functions (outputs with a grad_fn, backward through K2/K3/K5)
    and the bare kernel wrappers raise instead of returning an output that
    would cut the gradient."""
    q, k, v, do = (x.requires_grad_() for x in _qkv_do(cuda, torch.bfloat16, 64, 600, 2, 40))
    o = fa.flash_attention(q, k, v)
    assert o.grad_fn is not None
    before = (fa.launches_dq, fa.launches_dkv)
    o.backward(do.detach())
    assert (fa.launches_dq, fa.launches_dkv) == (before[0] + 1, before[1] + 1)
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v))
    with pytest.raises(RuntimeError, match="grad_fn"):
        fa.flash_attention_lse(q, k, v)
    x = torch.randn(16, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(256, 64, device="cuda", dtype=torch.bfloat16) * 0.1
    b = torch.zeros(256, device="cuda", dtype=torch.bfloat16)
    y = gg.geglu(x, w, b)
    assert y.grad_fn is not None
    before = gg.launches_dx
    y.sum().backward()
    assert gg.launches_dx == before + 1 and x.grad is not None
    with pytest.raises(RuntimeError, match="grad_fn"):
        gg._forward(x, w, b)
