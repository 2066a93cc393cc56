"""fairdiff_torch CUDA kernels against their plain PyTorch versions on the
card, at small and ragged shapes. Marked `gpu`: they skip where there is no
CUDA device (a CUDA kernel has no CPU or interpret mode) and run on the
card with `python -m pytest tests/test_torch_kernels_gpu.py -m gpu`.

Tolerances: fp32 kernels vs the fp64 plain version differ in summation
order only (1e-5; 1e-4 for the backward kernels, whose outputs are sums of
S*T products of exponentials). bf16 kernels vs the bf16 plain version differ by bf16
rounding noise (~2e-3 of the output's scale), so the limits are set against
that scale: every element within 0.1 * rms(plain) + 1e-2 * |plain|, rel L2
within 1e-2 (a kernel that drops a 64-key tile or a 64-deep K slot moves
the output by 1e-1 or more), and the kernel's rel L2 error against the
fp64 version at most 1.5 times the plain bf16 version's. K6 (the merged backward) sums dq
over key blocks with bulk reduce-adds in no fixed order: only summation order differs
from the plain version and K2, so the same limits hold.
"""

import dataclasses

import pytest
import torch

from chip_smoke import PAIR_VJP_LAUNCHES, PAIR_VJP_LAUNCHES_LORA, UNET_CALL_LAUNCHES, launch_counts, reset_counts
from fairdiff_torch.adapters import lora as lora_lib
from fairdiff_torch.models.layers import FusedGroupNorm, dot_product_attention, expand_padding_mask
from fairdiff_torch.models.unet2d import UNet2DCondition, UNetConfig
from fairdiff_torch.ops import flash_attention as fa
from fairdiff_torch.ops import geglu as gg
from fairdiff_torch.ops import group_norm as gn
from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
from fairdiff_torch.training.debias import DebiasTrainer
from fairdiff_torch.training.presets import PRESETS
from fairdiff_torch.training.synthetic import synthetic_stack
from fairdiff_torch.utils import profiling
from fairdiff_torch.utils.tree import tree_leaves, tree_map

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
@pytest.mark.parametrize("s,t,h,d", [(600, 300, 2, 40), (77, 1030, 3, 80), (5, 64, 1, 16), (130, 200, 2, 128),
                                     (33, 70, 2, 20), (576, 576, 2, 160), (77, 600, 2, 160)])
def test_flash_kernel_matches_plain(cuda, dtype, s, t, h, d):
    q = torch.randn(2, s, h, d, generator=cuda, device="cuda", dtype=dtype)
    k = torch.randn(2, t, h, d, generator=cuda, device="cuda", dtype=dtype)
    v = torch.randn(2, t, h, d, generator=cuda, device="cuda", dtype=dtype)
    before = fa.launches
    got = fa.flash_attention(q, k, v)
    assert fa.launches == before + 1
    exact = fa.flash_attention_plain(q.double(), k.double(), v.double())
    assert_matches(got, fa.flash_attention_plain(q, k, v), exact)


# K4 at its edges (M off its 64- and 128-row tiles, I off its 128- and
# 64-column tiles and not a multiple of 8, so y leaves by plain stores; d off
# its 64-deep K slot: 16, 24, 48; d = 1280 at M = 512, the pair VJP's mid
# block) and at the eight path shapes (generation's 4 rows, a pair VJP's 8)
GEGLU_SHAPES = [(37, 24, 100), (1000, 320, 1280), (64, 1280, 5120), (3, 48, 64), (130, 16, 33),
                (200, 40, 136), (512, 1280, 5120),
                (16384, 320, 1280), (4096, 640, 2560), (1024, 1280, 5120), (256, 1280, 5120),
                (32768, 320, 1280), (8192, 640, 2560), (2048, 1280, 5120)]


def _geglu_inputs(cuda, dtype, m, d, inner):
    x = torch.randn(m, d, generator=cuda, device="cuda").to(dtype)
    w = (torch.randn(2 * inner, d, generator=cuda, device="cuda") * d**-0.5).to(dtype)
    b = (torch.randn(2 * inner, generator=cuda, device="cuda") * 0.1).to(dtype)
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,inner", GEGLU_SHAPES)
def test_geglu_kernel_matches_plain(cuda, dtype, m, d, inner):
    """K4 against its plain version, and in bf16 run twice: every y element
    is written once by one tile, so both runs are bit-equal. The reference
    is fp64, or fp32 at the path shapes."""
    x, w, b = _geglu_inputs(cuda, dtype, m, d, inner)
    before = gg.launches
    got = gg.geglu(x, w, b)
    assert gg.launches == before + 1
    xd = torch.float32 if m * d * inner > 2**28 else torch.float64
    exact = gg.geglu_plain(x.to(xd), w.to(xd), b.to(xd))
    assert_matches(got, gg.geglu_plain(x, w, b), exact)
    if dtype == torch.bfloat16:
        assert torch.equal(gg.geglu(x, w, b), got)


@pytest.mark.parametrize("tile", [(64, 128), (128, 128), (128, 64)])
@pytest.mark.parametrize("m,d,inner", [(37, 24, 100), (130, 16, 33), (200, 40, 136), (1000, 320, 1280),
                                       (512, 1280, 5120)])
def test_geglu_kernel_every_tile(cuda, tile, m, d, inner):
    """Every y tile the bf16 kernel offers (`FWD_TILES`: ping-pong 64 x 128,
    cooperative 128 x 128 and 128 x 64), whichever `fwd_tile` picks."""
    x, w, b = _geglu_inputs(cuda, torch.bfloat16, m, d, inner)
    got = gg.geglu_with_tile(x, w, b, tile)
    assert_matches(got, gg.geglu_plain(x, w, b), gg.geglu_plain(x.double(), w.double(), b.double()))


def test_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.randn(1, 8, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q[:, ::2], q[:, ::2], q[:, ::2])
    q176 = torch.randn(1, 8, 2, 176, device="cuda", dtype=torch.bfloat16)  # above the largest head dim, 160
    with pytest.raises(ValueError, match="head dims up to 160"):
        fa.flash_attention(q176, q176, q176)
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


FLASH_SHAPES = [(600, 300, 2, 40), (77, 1030, 3, 80), (5, 64, 1, 16), (130, 200, 2, 128), (33, 70, 2, 20),
                (576, 576, 2, 160), (77, 600, 2, 160)]


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


# SDXL's self-attention at 1024 px, CFG batch 10: D = 64 at 4096 tokens (640
# channels, 10 heads) and 1024 tokens (1280 channels, 20 heads). The plain and
# fp64 versions run two rows at a time (their [B, H, S, T] scores would not fit
# at once); each row is independent, so the pieces are the whole.
SDXL_FLASH_SHAPES = [(20, 4096, 10, 64), (20, 1024, 20, 64)]


def _by_rows(fn, *xs, rows=2):
    outs = [fn(*(x[i:i + rows] for x in xs)) for i in range(0, xs[0].shape[0], rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


@pytest.mark.parametrize("kernel", ["fwd", "fwd_lse", "bwd"])
@pytest.mark.parametrize("b,s,h,d", SDXL_FLASH_SHAPES)
def test_flash_kernels_at_sdxl_shapes(cuda, kernel, b, s, h, d):
    """K1, K1-lse, and K2 + K3 at D = 64, bf16, against their plain versions."""
    mk = lambda: torch.randn(b, s, h, d, generator=cuda, device="cuda", dtype=torch.bfloat16)
    q, k, v, do = mk(), mk(), mk(), mk()
    f64 = lambda *xs: tuple(x.double() for x in xs)
    if kernel == "fwd":
        got = fa.flash_attention(q, k, v)
        assert_matches(got, _by_rows(fa.flash_attention_plain, q, k, v),
                       _by_rows(lambda *x: fa.flash_attention_plain(*f64(*x)), q, k, v))
        return
    o, lse = fa.flash_attention_lse(q, k, v)
    if kernel == "fwd_lse":
        o_plain, _ = _by_rows(fa.flash_attention_lse_plain, q, k, v)
        o_exact, lse_exact = _by_rows(lambda *x: fa.flash_attention_lse_plain(*f64(*x)), q, k, v)
        assert_matches(o, o_plain, o_exact)
        torch.testing.assert_close(lse.double(), lse_exact, atol=1e-4, rtol=1e-5)
        return
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    plain = _by_rows(fa.flash_attention_bwd_plain, q, k, v, o, lse, do)

    def exact(q, k, v, do):
        o_e, lse_e = fa.flash_attention_lse_plain(*f64(q, k, v))
        return fa.flash_attention_bwd_plain(*f64(q, k, v), o_e, lse_e, do.double())

    for g, p_, e in zip(got, plain, _by_rows(exact, q, k, v, do)):
        assert_matches(g, p_, e)


# the short-key attention that K1 takes where no gradient is wanted
# (`models/layers.py attention_route`), as (B, S, H, D, T, masked): SD-1.5's
# cross-attention over 77 keys with eos key masks at each level's head dim,
# SDXL's unmasked at 1024 px, and SD-1.5's short self-attention (T = S); then
# small shapes in both dtypes (the CPU-sized UNets' head dims 16 and 32 at
# their 16 keys, T off the key tile)
SHORT_KEY_SHAPES = [(20, 4096, 8, 40, 77, True), (20, 1024, 8, 80, 77, True), (20, 256, 8, 160, 77, True),
                    (20, 64, 8, 160, 77, True), (20, 1024, 20, 64, 77, False), (20, 4096, 10, 64, 77, False),
                    (20, 256, 8, 160, 256, False), (20, 64, 8, 160, 64, False)]
SMALL_MASKED_SHAPES = [(3, 300, 3, 40, 77), (3, 33, 2, 16, 16), (3, 100, 2, 32, 16), (3, 130, 2, 160, 200)]
EOS_LENGTHS = (1, 9, 77)


def _masked_case(cuda, dtype, b, s, h, d, t, masked):
    """q, k, v and a key mask whose rows keep the first 1, 9 or 77 keys in
    turn (at most t), or None."""
    mk = lambda n: torch.randn(b, n, h, d, generator=cuda, device="cuda", dtype=dtype)
    q, k, v = mk(s), mk(t), mk(t)
    if not masked:
        return q, k, v, None
    lengths = torch.tensor(EOS_LENGTHS, device="cuda").clamp(max=t).repeat(b)[:b]
    return q, k, v, (torch.arange(t, device="cuda")[None] < lengths[:, None]).int()


def _bias_path(q, k, v, mask):
    """The plain attention with the additive `expand_padding_mask` bias, and
    its fp64 twin (fp32 logits, fp64 P.V)."""
    bias = None if mask is None else expand_padding_mask(mask)
    return (dot_product_attention(q, k, v, bias),
            dot_product_attention(q.double(), k.double(), v.double(), bias))


def _check_short_key_route(q, k, v, mask):
    before = (fa.launches, fa.launches_short, fa.launches_lse)
    got = dot_product_attention(q, k, v, use_flash=True, key_mask=mask)
    assert (fa.launches, fa.launches_short, fa.launches_lse) == (before[0] + 1, before[1] + 1, before[2])
    plain, exact = _bias_path(q, k, v, mask)
    assert_matches(got, plain, exact)
    if mask is not None:  # the mutation control: K1 with the mask ignored fails the same check
        with pytest.raises(AssertionError):
            assert_matches(fa.flash_attention(q, k, v), plain, exact)
    return got


@pytest.mark.parametrize("b,s,h,d,t,masked", SHORT_KEY_SHAPES)
def test_short_key_k1_at_the_unets_shapes(cuda, b, s, h, d, t, masked):
    """The route without a gradient: one K1 launch (counted short-key), the
    masked K1 where there is a key mask, against the plain path with the
    additive bias in bf16 (the kernel checks' tolerance); the mask ignored
    fails that check; a second run is bit-equal."""
    q, k, v, mask = _masked_case(cuda, torch.bfloat16, b, s, h, d, t, masked)
    with torch.no_grad():
        got = _check_short_key_route(q, k, v, mask)
        assert torch.equal(fa.flash_attention(q, k, v, key_mask=mask), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,t", SMALL_MASKED_SHAPES)
def test_masked_k1_small_shapes(cuda, dtype, b, s, h, d, t):
    """The masked K1 (bf16, and the fp32 simple kernel) at small shapes
    against the plain path's bias, with eos masks and with masks that keep
    only each row's last quarter, half or key: at T = 200 and D = 160
    (64-key tiles) a row's first tiles are wholly masked, where its running
    max is still -inf."""
    q, k, v, mask = _masked_case(cuda, dtype, b, s, h, d, t, True)
    _check_short_key_route(q, k, v, mask)
    late = (torch.arange(t, device="cuda")[None] >= torch.tensor([t * 3 // 4, t // 2, t - 1], device="cuda")[:, None])
    _check_short_key_route(q, k, v, late.int())


def test_masked_k1_refuses_what_it_does_not_take(cuda):
    """A head dim the masked K1 is not built for (D = 96), a mask of another
    shape, and a mask where a gradient is wanted raise."""
    q = torch.randn(2, 64, 2, 96, device="cuda", dtype=torch.bfloat16)
    mask = torch.ones(2, 64, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dims padded"):
        fa.flash_attention(q, q, q, key_mask=mask)
    with pytest.raises(ValueError, match="key mask"):
        fa.flash_attention(q[..., :64].contiguous(), q[..., :64].contiguous(), q[..., :64].contiguous(),
                           key_mask=mask[:, :10])
    x = q[..., :64].contiguous().requires_grad_()
    with pytest.raises(ValueError, match="gradient route takes no key mask"):
        fa.flash_attention(x, x, x, key_mask=mask)


def _full_unet(model: str):
    """A full-size bf16 UNet on the card (default init; only launch counts
    are read) and one CFG pair of its inputs: SD-1.5 at 512 px with eos key
    masks of 9 and 77 keys, or SDXL at 1024 px with its added conditioning."""
    cfg = UNetConfig.sd15() if model == "sd15" else UNetConfig.sdxl()
    with torch.device("cuda"):
        unet = UNet2DCondition(cfg).to(torch.bfloat16).requires_grad_(False).eval()
    n = cfg.sample_size
    lat = torch.randn(2, n, n, 4, device="cuda")
    ctx = torch.randn(2, 77, cfg.cross_attention_dim, device="cuda", dtype=torch.bfloat16)
    if model == "sd15":
        mask = (torch.arange(77, device="cuda")[None] < torch.tensor([[9], [77]], device="cuda")).int()
        return unet, lat, ctx, mask, None
    added = {"text_embeds": torch.randn(2, 1280, device="cuda"),
             "time_ids": torch.tensor([1024.0, 1024, 0, 0, 1024, 1024], device="cuda").expand(2, 6)}
    return unet, lat, ctx, None, added


# (K1 launches, of them short-key or masked, long-key self-attention sites,
# feed-forwards) of one UNet call
UNET_SITES = {"sd15": (32, 22, 10, 16), "sdxl": (140, 70, 70, 70)}


@pytest.mark.parametrize("model", ["sd15", "sdxl"])
def test_unet_call_k1_launch_counts(cuda, model):
    """One no-grad CFG UNet call at full size launches K1 at every
    attention: 32 on SD-1.5 at 512 px (22 short-key or masked) and 140 on
    SDXL at 1024 px (70), and no other flash kernel. A call with a gradient
    through the context runs the flash kernels at the long-key
    self-attention alone, as before the short-key route: K1 without lse once
    (the first block's self-attention, whose input does not depend on the
    context) and K1-lse, K2 and K3 at the other 9 (SD-1.5) or 69 (SDXL)
    sites; no short-key launch."""
    unet, lat, ctx, mask, added = _full_unet(model)
    k1, short, long_self, ffs = UNET_SITES[model]
    zero = {k: 0 for k in launch_counts()}
    reset_counts()
    with torch.no_grad():
        eps = unet(lat, 500, ctx, mask, added_cond=added)
    torch.cuda.synchronize()
    assert launch_counts() == dict(zero, flash_attention=k1, flash_attention_short=short, geglu=ffs)
    assert eps.shape == lat.shape
    reset_counts()
    ctx = ctx.clone().requires_grad_()
    eps = unet(lat, 500, ctx, mask, added_cond=added)
    (grad,) = torch.autograd.grad(eps.float().square().mean(), ctx)
    torch.cuda.synchronize()
    want = dict(zero, flash_attention=1, flash_attention_lse=long_self - 1, flash_attention_dq=long_self - 1,
                flash_attention_dkv=long_self - 1, geglu=ffs, geglu_dx=ffs)
    assert launch_counts() == want and grad.shape == ctx.shape


# K5 at ragged shapes (d and I off its 160-column and 64-deep tiles, M off
# its 128 rows, one row, odd I) and at the four phase-4 path shapes (a pair
# VJP's 8 rows; [512, 1280] splits its dx product's K over blocks)
DX_SHAPES = [(37, 24, 100), (1000, 320, 1280), (64, 1280, 5120), (3, 48, 64), (130, 16, 33), (300, 640, 2560),
             (32768, 320, 1280), (8192, 640, 2560), (2048, 1280, 5120), (512, 1280, 5120)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,inner", DX_SHAPES)
def test_geglu_dx_kernel_matches_plain(cuda, dtype, m, d, inner):
    """K5 against its plain version, and run twice: dproj is written once
    and the dx product (and its split-K partials) summed in a fixed order, so
    both runs are bit-equal. The reference is fp64, or fp32 at the path
    shapes."""
    x = torch.randn(m, d, generator=cuda, device="cuda").to(dtype)
    w = (torch.randn(2 * inner, d, generator=cuda, device="cuda") * d**-0.5).to(dtype)
    b = (torch.randn(2 * inner, generator=cuda, device="cuda") * 0.1).to(dtype)
    dy = torch.randn(m, inner, generator=cuda, device="cuda").to(dtype)
    before = gg.launches_dx
    got = gg.geglu_dx(x, w, b, dy)
    assert gg.launches_dx == before + 1
    xd = torch.float32 if m * d * inner > 2**28 else torch.float64
    exact = gg.geglu_dx_plain(x.to(xd), w.to(xd), b.to(xd), dy.to(xd))
    assert_matches(got, gg.geglu_dx_plain(x, w, b, dy), exact, f32_tol=dict(atol=1e-4, rtol=1e-4))
    if dtype == torch.bfloat16:
        assert torch.equal(gg.geglu_dx(x, w, b, dy), got)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,h,d", FLASH_SHAPES + [(200, 129, 2, 40), (200, 129, 2, 160), (93, 130, 2, 144),
                                                    (77, 65, 3, 136)])
def test_flash_merged_bwd_kernel_matches_plain_and_split(cuda, dtype, s, t, h, d):
    """K6 against its plain version (the same function as K2 + K3) and
    against K2 + K3 on the same inputs, at S and T that are not multiples of
    64 (and T = 129: one key past the last whole key block, of 128 keys, or
    of 64 above D = 128), at every head dim: one K6 launch, no K2 or K3."""
    q, k, v, do = _qkv_do(cuda, dtype, s, t, h, d)
    o, lse = fa.flash_attention_lse(q, k, v)
    before = (fa.launches_merged, fa.launches_dq, fa.launches_dkv)
    got = fa.flash_attention_bwd_merged(q, k, v, o, lse, do)
    assert (fa.launches_merged, fa.launches_dq, fa.launches_dkv) == (before[0] + 1, *before[1:])
    assert all(g.dtype == dtype and g.shape == x.shape for g, x in zip(got, (q, k, v)))
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    split = fa.flash_attention_bwd(q, k, v, o, lse, do)
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    o_exact, lse_exact = fa.flash_attention_lse_plain(qd, kd, vd)
    exact = fa.flash_attention_bwd_plain(qd, kd, vd, o_exact, lse_exact, dod)
    for g, p_, sp, e in zip(got, plain, split, exact):
        assert_matches(g, p_, e, f32_tol=dict(atol=1e-4, rtol=1e-4))
        assert_matches(g, sp, e, f32_tol=dict(atol=1e-4, rtol=1e-4))


# the edges of the key-block backward (K3 and K6, one wgmma kernel fed by TMA):
# layouts TMA cannot address (a 40-byte head stride at D = 20, H = 3; an odd
# head dim; at DP = 160, a 300-byte head stride at D = 150 and an odd D =
# 145), S shorter than its ring of three 64-row q tiles, T off its 128-key
# tile (64 for K6 above D = 128), and the UNet's path shapes at B*H = 64, as
# (B, S, T, H, D)
KV_EDGE_SHAPES = [(2, 33, 70, 3, 20), (2, 9, 40, 1, 7), (2, 100, 256, 2, 40), (2, 64, 300, 2, 80),
                  (1, 150, 1000, 3, 64), (8, 4096, 4096, 8, 40), (8, 1024, 1024, 8, 80),
                  (2, 77, 600, 2, 160), (8, 576, 576, 8, 160), (2, 70, 130, 3, 150), (2, 33, 65, 1, 145)]


@pytest.mark.parametrize("b,s,t,h,d", KV_EDGE_SHAPES)
def test_flash_key_block_bwd_edges(cuda, b, s, t, h, d):
    """K3 and K6 against the plain backward at the key-block kernel's edges,
    and each run twice: dk and dv are written once, by one block, in a fixed
    order, so both runs are bit-equal. The reference is fp64, or fp32 at the
    UNet shapes (an fp64 [B, H, S, T] there is 8.6 GB a tensor). The merged
    route is one K6 launch at every head dim."""
    mk = lambda n: torch.randn(b, n, h, d, generator=cuda, device="cuda", dtype=torch.bfloat16)
    q, k, v, do = mk(s), mk(t), mk(t), mk(s)
    o, lse = fa.flash_attention_lse(q, k, v)
    delta = fa.attention_delta(o, do)
    before = (fa.launches_dkv, fa.launches_merged, fa.launches_dq)
    dkv = fa.flash_attention_dkv(q, k, v, do, lse, delta)
    merged = fa.flash_attention_bwd_merged(q, k, v, o, lse, do)
    assert (fa.launches_dkv, fa.launches_merged, fa.launches_dq) == (before[0] + 1, before[1] + 1, before[2])
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    xd = torch.float32 if b * h * s * t > 2**26 else torch.float64
    qx, kx, vx, dox = (x.to(xd) for x in (q, k, v, do))
    o_x, lse_x = fa.flash_attention_lse_plain(qx, kx, vx)
    exact = fa.flash_attention_bwd_plain(qx, kx, vx, o_x, lse_x, dox)
    for g, p_, e in zip((*merged, *dkv), (*plain, *plain[1:]), (*exact, *exact[1:])):
        assert_matches(g, p_, e)
    again = fa.flash_attention_dkv(q, k, v, do, lse, delta)
    assert torch.equal(dkv[0], again[0]) and torch.equal(dkv[1], again[1])
    again = fa.flash_attention_bwd_merged(q, k, v, o, lse, do)
    assert torch.equal(merged[1], again[1]) and torch.equal(merged[2], again[2])


# the edges of the query-block kernels (K1, K2: one wgmma kernel design fed
# by TMA, 128 q rows a block, 128-key tiles up to D = 80 and 64-key tiles
# above): layouts TMA cannot address (D = 20 at H = 3; an odd D), S shorter
# than a block, S off it, T off the key tile and T shorter than one,
# D = 128, and the UNet's two path shapes, as (B, S, T, H, D)
Q_EDGE_SHAPES = [(2, 33, 70, 3, 20), (2, 9, 40, 1, 7), (2, 100, 256, 2, 40), (1, 300, 1000, 3, 64),
                 (2, 64, 300, 2, 80), (2, 130, 50, 2, 40), (2, 200, 129, 2, 128),
                 (8, 4096, 4096, 8, 40), (8, 1024, 1024, 8, 80), (2, 77, 600, 2, 160), (8, 576, 576, 8, 160)]


@pytest.mark.parametrize("b,s,t,h,d", Q_EDGE_SHAPES)
def test_flash_query_block_edges(cuda, b, s, t, h, d):
    """K1 (with and without lse) and K2 against their plain versions at the
    query-block kernels' edges, and each run twice: every o, lse and dq
    element is written once, by one block, in a fixed order, so both runs
    are bit-equal. The reference is fp64, or fp32 at the UNet shapes."""
    mk = lambda n: torch.randn(b, n, h, d, generator=cuda, device="cuda", dtype=torch.bfloat16)
    q, k, v, do = mk(s), mk(t), mk(t), mk(s)
    before = (fa.launches, fa.launches_lse, fa.launches_dq)
    o = fa.flash_attention(q, k, v)
    o_l, lse = fa.flash_attention_lse(q, k, v)
    delta = fa.attention_delta(o_l, do)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta)
    assert (fa.launches, fa.launches_lse, fa.launches_dq) == tuple(n + 1 for n in before)
    xd = torch.float32 if b * h * s * t > 2**26 else torch.float64
    qx, kx, vx, dox = (x.to(xd) for x in (q, k, v, do))
    o_lx, lse_x = fa.flash_attention_lse_plain(qx, kx, vx)
    o_lp, _ = fa.flash_attention_lse_plain(q, k, v)
    assert_matches(o, fa.flash_attention_plain(q, k, v), fa.flash_attention_plain(qx, kx, vx))
    assert_matches(o_l, o_lp, o_lx)
    torch.testing.assert_close(lse.to(xd), lse_x, atol=1e-4, rtol=1e-5)
    assert_matches(dq, fa.flash_attention_dq_plain(q, k, v, do, lse, delta),
                   fa.flash_attention_dq_plain(qx, kx, vx, dox, lse_x, fa.attention_delta(o_lx, dox)))
    assert torch.equal(fa.flash_attention(q, k, v), o)
    o2, lse2 = fa.flash_attention_lse(q, k, v)
    assert torch.equal(o2, o_l) and torch.equal(lse2, lse)
    assert torch.equal(fa.flash_attention_dq(q, k, v, do, lse, delta), dq)


def test_flash_merged_route_through_autograd(cuda):
    """flash_bwd="merged" sends the autograd backward through K6 only."""
    q, k, v, do = (x.requires_grad_() for x in _qkv_do(cuda, torch.bfloat16, 64, 600, 2, 40))
    before = (fa.launches_merged, fa.launches_dq, fa.launches_dkv)
    fa.flash_attention(q, k, v, flash_bwd="merged").backward(do.detach())
    assert (fa.launches_merged, fa.launches_dq, fa.launches_dkv) == (before[0] + 1, *before[1:])
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v))
    with pytest.raises(ValueError, match="flash_bwd"):
        fa.flash_attention(q, k, v, flash_bwd="pallas")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_recompute_route_through_autograd(cuda, dtype):
    """flash_bwd="recompute" runs K1 without lse and no backward kernel; its
    gradients are the plain attention's autograd (the same ops, bit for
    bit) and agree with the split route's (K1-lse, K2, K3): fp32 within
    1e-4, bf16 within the rel L2 two bf16 backward routes are held to in a
    pair VJP (3e-2)."""
    q, k, v, do = _qkv_do(cuda, dtype, 64, 600, 2, 40)
    names = ("launches", "launches_lse", "launches_dq", "launches_dkv", "launches_merged")

    def grads(fn):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        fn(*xs).backward(do)
        return [x.grad for x in xs]

    before = [getattr(fa, n) for n in names]
    got = grads(lambda *xs: fa.flash_attention(*xs, flash_bwd="recompute"))
    assert [getattr(fa, n) for n in names] == [before[0] + 1, *before[1:]]
    plain = grads(fa.flash_attention_plain)
    split = grads(lambda *xs: fa.flash_attention(*xs, flash_bwd="split"))
    for g, p_, s_ in zip(got, plain, split):
        assert torch.equal(g, p_)
        if dtype == torch.float32:
            torch.testing.assert_close(g, s_, atol=1e-4, rtol=1e-4)
        else:
            assert ((g.float() - s_.float()).norm() / s_.float().norm()).item() <= 3e-2


def test_eval_images_on_the_card_matches_the_cpu(cuda, tmp_path):
    """`eval_images` on a tiny folder of face scenes (assets/detector.npz,
    three seeded MobileNetV3-Large heads): the card's pickles against
    `device="cpu"`: indicators and boxes equal, logits within rel L2 1e-4."""
    import pickle

    import numpy as np

    from chip_smoke import DETECTOR_NPZ, _eval_heads
    from fairdiff_torch.guidance.detector_train import render_face_scene_dr
    from fairdiff_torch.io.images import save_png
    from fairdiff_torch.tools import eval_images

    rng = np.random.default_rng(0)
    for i in range(6):
        save_png(render_face_scene_dr(rng, 128)[0], tmp_path / "imgs" / "p" / f"img_{i}.png")
    heads = _eval_heads(tmp_path)
    out = {}
    for dev in ("cuda", "cpu"):
        eval_images.main(eval_images.EvalImagesConfig(
            device=dev, generated_imgs_dir=str(tmp_path / "imgs"), save_dir=str(tmp_path / dev),
            detector_params=str(DETECTOR_NPZ), batch_size=4, chip_size=64, **heads))
        with open(tmp_path / dev / "p_test_results.pkl", "rb") as f:
            out[dev] = pickle.load(f)
    got, want = out["cuda"], out["cpu"]
    assert got[0].any()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)


# (shape, groups): C = 960 and 2560 at 64 rows, ragged row counts (7 x 5 and
# 9 x 9 rows do not divide into a cluster's slices), a single row, C % 8 != 0
# (channel-by-channel loads), the path's largest shape
GN_CASES = [((2, 8, 8, 960), 32), ((2, 8, 8, 2560), 32), ((3, 64, 320), 32), ((1, 5, 7, 48), 4),
            ((2, 1, 1, 64), 8), ((8, 4096, 40), 8), ((2, 9, 9, 12), 4), ((8, 64, 64, 960), 32)]


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_group_norm_kernel_matches_plain(cuda, dtype, shape, groups, silu):
    """K7 against its plain version (GN_CASES), fp32 and bf16, with and
    without SiLU, and run twice: the cluster sums its CTAs' partials in rank
    order, so both runs are bit-equal. The input carries a trend along the
    rows, so a kernel that drops rows from the statistics is seen."""
    C = shape[-1]
    rows = torch.linspace(0.0, 3.0, int(torch.tensor(shape[1:-1]).prod()), device="cuda")
    x = (torch.randn(shape, generator=cuda, device="cuda") + rows.reshape(1, *shape[1:-1], 1)).to(dtype)
    w = 1.0 + 0.1 * torch.randn(C, generator=cuda, device="cuda")
    b = 0.1 * torch.randn(C, generator=cuda, device="cuda")
    before = gn.launches
    got = gn.fused_group_norm_silu(x, w, b, groups, 1e-5, silu)
    assert gn.launches == before + 1 and got.dtype == dtype and got.shape == x.shape
    exact = gn.group_norm_silu_plain(x.double(), w.double(), b.double(), groups, 1e-5, silu)
    assert_matches(got, gn.group_norm_silu_plain(x, w, b, groups, 1e-5, silu), exact)
    assert torch.equal(gn.fused_group_norm_silu(x, w, b, groups, 1e-5, silu), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_module_gradients_match_plain(cuda, dtype):
    """FusedGroupNorm on the card: K7 forward, the plain version's autograd
    recomputed in the backward; its gradients in x, weight and bias equal the
    plain route's (the same computation)."""
    module = FusedGroupNorm(960, 32, 1e-5, use_silu=True).cuda()
    with torch.no_grad():
        module.weight.add_(0.1 * torch.randn(960, generator=cuda, device="cuda"))
    x = torch.randn(2, 8, 8, 960, generator=cuda, device="cuda").to(dtype).requires_grad_()
    dy = torch.randn(x.shape, generator=cuda, device="cuda").to(dtype)
    before = gn.launches
    module(x).backward(dy)
    assert gn.launches == before + 1
    xp, wp, bp = (t.detach().clone().requires_grad_() for t in (x, module.weight, module.bias))
    gn.group_norm_silu_plain(xp, wp, bp, 32, 1e-5, True).backward(dy)
    for got, want in ((x.grad, xp.grad), (module.weight.grad, wp.grad), (module.bias.grad, bp.grad)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="groups"):
        gn.fused_group_norm_silu(x.detach()[..., :900], module.weight[:900].detach(),
                                 module.bias[:900].detach(), 32, 1e-5)
    with pytest.raises(RuntimeError, match="grad_fn"):
        gn._forward(x, module.weight, module.bias, 32, 1e-5, True)


@pytest.mark.parametrize("experiment", ["exp3", "exp2"])
def test_tiny_train_step_runs_the_kernels(cuda, experiment):
    """One exp-3 step (gender x race, sampled OT) and one exp-2 step (the
    soft prefix) of the trainer on the card: the tiny SD in bf16 with remat
    at 64x64 latents, whose 32 attentions are the same K1 sites as SD-1.5's
    without a gradient (10 of them, over 4096 and 1024 tokens, the flash
    sites with one) and its 16 feed-forwards the same GEGLU sites (head dims
    16 and 32), 4 lanes, micro-batch 2, 2 denoising steps.
    Finite non-zero gradients, and every kernel launched as often as
    chip_smoke.py's counts of a CFG UNet call and a pair VJP say."""
    sd_cfg = dataclasses.replace(SDConfig.tiny(), unet=dataclasses.replace(UNetConfig.tiny(), sample_size=64),
                                 dtype="bfloat16")
    sd = StableDiffusion(sd_cfg, device="cuda", remat=True).init_random(0)
    cfg = PRESETS[experiment](lora_rank=2, train_images_per_prompt=4, train_micro_batch=2, steps_low=2, steps_high=2)
    trainer = DebiasTrainer(sd, synthetic_stack(cfg.attributes, device=sd.device), cfg)
    state = trainer.init_state(0)
    reset_counts()
    state, logs = trainer.train_step(state, (torch.tensor([[0, 5, 6, 63]]), torch.tensor([[0, 63, 1, 1]])))
    calls, pairs = 2 * 2, 2 * 2  # no-grad CFG UNet calls (phases 1 and 3); pair VJPs (steps x lane chunks)
    want = {k: calls * UNET_CALL_LAUNCHES.get(k, 0) + pairs * v for k, v in PAIR_VJP_LAUNCHES.items()}
    assert launch_counts() == want
    assert logs["grads_finite"] and logs["grad_norm"] > 0 and state.step == 1
    assert set(state.adapters) == ({"prefix"} if experiment == "exp2" else {"te_lora"})


def test_tiny_unet_lora_pair_vjp_remat_on_and_off(cuda):
    """A pair VJP of the tiny SD's UNet in bf16 at 64x64 latents (the same 10
    flash sites and 16 feed-forwards as SD-1.5) with a rank-2 UNet LoRA
    (`up` non-zero) through `StableDiffusion.unet_eps`: the LoRA and context
    gradients with remat on equal those with remat off within rel L2 1e-3
    (the recompute runs the same kernels on the same operands), and the
    launches are chip_smoke.py's counts with and without the recompute."""
    sd_cfg = dataclasses.replace(SDConfig.tiny(), unet=dataclasses.replace(UNetConfig.tiny(), sample_size=64),
                                 dtype="bfloat16")
    sd = StableDiffusion(sd_cfg, device="cuda", remat=True).init_random(0)
    g = torch.Generator().manual_seed(1)
    lora = lora_lib.init_lora(sd.unet, lora_lib.unet_attention_targets, 2, g)
    lora = tree_map(lambda x: (torch.randn(x.shape, generator=g) * 0.1 if x.abs().max() == 0 else x).cuda(), lora)
    leaves = [x.requires_grad_() for x in tree_leaves(lora)]
    x = torch.randn(2, 64, 64, 4, generator=g).cuda()
    cot = torch.randn(2, 64, 64, 4, generator=g).cuda()
    ctx0 = torch.randn(4, 4, 32, generator=g).cuda().bfloat16()

    def grads():
        ctx = ctx0.clone().requires_grad_()
        eps2 = sd.unet_eps(torch.cat([x, x]), 500, ctx, None, unet_weights=lora_lib.apply_lora(sd.unet, lora))
        out = torch.autograd.grad((eps2.float() * torch.cat([cot, cot])).sum(), [ctx, *leaves])
        return torch.cat([o.float().flatten() for o in out[1:]]), out[0].float()

    runs = {}
    for remat in (True, False):
        sd.unet.remat = remat
        reset_counts()
        runs[remat] = grads(), launch_counts()
    (on, counts_on), (off, counts_off) = runs[True], runs[False]
    assert counts_on == PAIR_VJP_LAUNCHES_LORA
    assert counts_off == dict(PAIR_VJP_LAUNCHES_LORA, flash_attention_lse=10, geglu=16)
    for a, b in zip(on, off):
        assert torch.isfinite(a).all() and a.abs().max() > 0
        assert ((a - b).norm() / b.norm()).item() <= 1e-3


def test_spans_read_device_durations_without_a_sync(cuda):
    """The span recorder on the card: spans entered and left over device work
    and their durations read later, all under the sync debug mode "error"
    (no call of the recorder waits for the device); a span inside a CUDA
    graph's capture records no event."""
    x = torch.randn(1024, 1024, generator=cuda, device="cuda")
    rec = profiling.SpanRecorder()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with rec.span("outer") as outer:
            for _ in range(4):
                with rec.span("inner"):
                    x = torch.tanh(x @ x)
        rec.spans()  # reads what has completed, waits for nothing
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        spans = rec.spans()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [s.name for s in spans] == ["inner"] * 4 + ["outer"]
    assert all(s.device_ns is not None and s.device_ns > 0 for s in spans)
    assert outer.device_ns >= sum(s.device_ns for s in spans[:4])
    assert not rec._pending and 2 <= rec._made <= 10 and len(rec._free) == rec._made  # every event back in the pool

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x @ x  # warm-up before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with rec.span("captured") as captured:
            y = x @ x
    graph.replay()
    torch.cuda.synchronize()
    assert captured.device_ns is None and captured._events is None and y.isfinite().all()
