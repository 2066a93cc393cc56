"""fairdiff_torch fused GEGLU (K4) against the JAX package.

The port's plain version runs here (CPU tensors); the JAX `_geglu_forward`
runs its Pallas kernel in interpret mode, as tests/test_geglu.py does.
Float32 inputs from one numpy seed. Tolerance 2e-5: the same fp32
projection and gelu, differing in summation order and in the JAX kernel's
A&S erf (|error| <= 1.5e-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import fairdiff.models.unet2d as junet
import fairdiff.ops.geglu as jgeglu
from fairdiff_torch.io.from_jax import load_jax_params, state_dict_from_jax
from fairdiff_torch.models.unet2d import FeedForwardGEGLU
from fairdiff_torch.ops import geglu as tgeglu

torch.set_num_threads(1)


def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("m,d,inner", [(8, 16, 64), (37, 24, 128), (300, 32, 512)])
def test_plain_matches_jax_geglu_forward(monkeypatch, m, d, inner):
    _interpret(monkeypatch)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(m, d)).astype(np.float32)
    w = (rng.normal(size=(d, 2 * inner)) * d**-0.5).astype(np.float32)  # JAX [d, 2I]
    b = (rng.normal(size=(2 * inner,)) * 0.1).astype(np.float32)
    want = np.asarray(jgeglu._geglu_forward(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    before = tgeglu.launches
    got = tgeglu.geglu(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)), torch.from_numpy(b)
    )
    assert got.shape == (m, inner)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert tgeglu.launches == before  # CPU tensors take the plain version


@pytest.mark.parametrize("fused", [True, False])
def test_feedforward_matches_jax_module(monkeypatch, fused):
    """The port's FeedForwardGEGLU (one `proj` Linear) against the JAX module
    with its fused-GEGLU gate on (Pallas, interpret) and off (Dense), with
    the JAX module's own init params carried over."""
    _interpret(monkeypatch)
    monkeypatch.setattr(jgeglu, "fused_geglu_enabled", lambda: fused)
    x = np.random.default_rng(1).normal(size=(2, 9, 16)).astype(np.float32)
    mod = junet.FeedForwardGEGLU(16)
    params = mod.init(jax.random.key(4), jnp.asarray(x))["params"]
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    ff = load_jax_params(FeedForwardGEGLU(16), params)
    with torch.no_grad():
        got = ff(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_wrapper_rejects_bad_weights():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="want w"):
        tgeglu.geglu(x, torch.zeros(8, 16), torch.zeros(16))  # JAX layout, not torch's
    with pytest.raises(TypeError, match="mixed dtypes"):
        tgeglu.geglu(x, torch.zeros(16, 8, dtype=torch.float64), torch.zeros(16))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tgeglu.geglu(x.to("meta"), torch.zeros(16, 8, device="meta"), torch.zeros(16, device="meta"))


# -- K5 and the autograd Function ---------------------------------------------


def _dx_inputs(m, d, inner, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    w = (rng.normal(size=(d, 2 * inner)) * d**-0.5).astype(np.float32)  # JAX [d, 2I]
    b = (rng.normal(size=(2 * inner,)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(m, inner)).astype(np.float32)
    tw = state_dict_from_jax({"proj": {"kernel": w, "bias": b}})["proj.weight"]  # torch [2I, d]
    return x, w, b, dy, tw


@pytest.mark.parametrize("m,d,inner", [(8, 16, 64), (37, 24, 128), (300, 32, 512)])
def test_dx_plain_matches_jax_dx_kernel(monkeypatch, m, d, inner):
    """`geglu_dx_plain` against the JAX `_geglu_dx` Pallas kernel
    (interpret mode). Tolerance 2e-5 as above: fp32 products, the JAX
    kernel's A&S erf."""
    _interpret(monkeypatch)
    x, w, b, dy, tw = _dx_inputs(m, d, inner)
    want = np.asarray(jgeglu._geglu_dx(*map(jnp.asarray, (x, w, b, dy))))
    before = tgeglu.launches_dx
    got = tgeglu.geglu_dx(torch.from_numpy(x), tw, torch.from_numpy(b), torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert tgeglu.launches_dx == before  # CPU tensors take the plain version


@pytest.mark.parametrize("frozen", [True, False])
def test_function_grads_match_jax_grad(monkeypatch, frozen):
    """`FusedGEGLU` on CPU tensors against jax.grad of the custom_vjp
    `fused_geglu`: dx always; dW and db only when the weights require grad
    (the frozen UNet's feed-forward does not ask for them)."""
    _interpret(monkeypatch)
    x, w, b, dy, tw = _dx_inputs(2 * 7, 16, 64, seed=5)
    x3 = x.reshape(2, 7, 16)
    jloss = lambda a, ww, bb: jnp.sum(jgeglu.fused_geglu(a, ww, bb) * jnp.asarray(dy).reshape(2, 7, -1))
    jdx, jdw, jdb = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x3, w, b)))
    tx = torch.from_numpy(x3).requires_grad_()
    tw.requires_grad_(not frozen)
    tb = torch.from_numpy(b).requires_grad_(not frozen)
    y = tgeglu.geglu(tx, tw, tb)
    assert isinstance(y.grad_fn, tgeglu.FusedGEGLU._backward_cls)
    (y * torch.from_numpy(dy).reshape(2, 7, -1)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=2e-5, rtol=2e-5)
    if frozen:
        assert tw.grad is None and tb.grad is None
    else:  # torch's dW is the JAX [d, 2I] one transposed
        np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(jdw), atol=1e-4, rtol=2e-5)
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), atol=1e-4, rtol=2e-5)


def test_dx_splits_fill_one_wave():
    """K5's split of its dx product's K = 2 Ip over blocks: none where its
    [128 x 320] output tiles fill the H100's 132 SMs (the pair VJP's
    [32768, 320]: 256 tiles; [8192, 640]: 128), 2 at [2048, 1280] (64
    tiles), 8 at [512, 1280] (16 tiles), and never under four 64-deep K
    tiles a split; dproj's halves are I rounded up to 64 columns."""
    for (m, d), want in {(32768, 320): 1, (8192, 640): 1, (2048, 1280): 2, (512, 1280): 8}.items():
        assert tgeglu.dx_splits(m, d, 4 * d) == want
    for m, d, inner in ((37, 24, 100), (3, 48, 64), (64, 1280, 5120), (130, 16, 33)):
        splits = tgeglu.dx_splits(m, d, inner)
        assert 1 <= splits <= max(1, 2 * tgeglu.dx_inner_pad(inner) // 64 // 4)
    assert [tgeglu.dx_inner_pad(i) for i in (33, 64, 100, 1280)] == [64, 64, 128, 1280]


# -- K4's host-side tile choice ------------------------------------------------

# K4's path shapes: generation's 4 UNet rows and a pair VJP's 8, x [M, d]
K4_PATH = [(16384, 320), (4096, 640), (1024, 1280), (256, 1280),
           (32768, 320), (8192, 640), (2048, 1280), (512, 1280)]


def _k4_schedule(m, inner, tile, sms=132):
    """The y rectangles [m0, m1) x [n0, n1) that csrc/geglu.cu's persistent
    K4 writes: min(tiles, SMs) blocks, block b walking tiles b, b + grid,
    ...; tile t is row block t % m_tiles of column block t // m_tiles; a
    128-row tile is two 64-row halves, one a consumer warpgroup."""
    rows, cols = tile
    m_tiles, n_tiles = -(-m // rows), -(-inner // cols)
    tiles = m_tiles * n_tiles
    grid = min(tiles, sms)
    out, per_block = [], []
    for b in range(grid):
        mine = range(b, tiles, grid)
        per_block.append(len(mine))
        for t in mine:
            m0, n0 = t % m_tiles * rows, t // m_tiles * cols
            for h0 in range(m0, m0 + rows, 64):
                if h0 < m:  # a half wholly past M stores nothing
                    out.append((h0, min(h0 + 64, m), n0, min(n0 + cols, inner)))
    return out, per_block


@pytest.mark.parametrize("m,d,inner", [(m, d, 4 * d) for m, d in K4_PATH] + [(37, 24, 100), (130, 16, 33),
                                                                               (3, 48, 64), (200, 40, 136)])
def test_fwd_tiles_cover_the_output_once(m, d, inner):
    """Every tile K4 offers covers y [M, I] exactly once: each element is
    written by one tile (so reruns are bit-equal), and the blocks' static
    walks differ by at most one tile."""
    assert tgeglu.fwd_tile(m, d, inner) in tgeglu.FWD_TILES
    for tile in tgeglu.FWD_TILES:
        rects, per_block = _k4_schedule(m, inner, tile)
        seen = np.zeros((m, inner), np.int32)
        for m0, m1, n0, n1 in rects:
            seen[m0:m1, n0:n1] += 1
        assert (seen == 1).all(), tile
        assert max(per_block) - min(per_block) <= 1


def test_fwd_tile_fills_the_sms():
    """Ping-pong at d = 320 (five K slots: the erff epilogue is as long as a
    tile's products), cooperative deeper; there the wide tile (128 h + 128 g
    columns) wherever its tiles number four waves of 132 SMs or more, and
    the narrow one (64 + 64) where it lowers the busiest SM's work by more
    than a tenth: at [1024, 1280] from 3 wide tiles (384 columns) to 5
    narrow (320), ratio 0.83; at [512, 1280] from 2 (256) to 3 (192), 0.75.
    At [256, 1280] both give one SM 128 columns: the wide tile stays."""
    want = {(16384, 320): tgeglu.FWD_PINGPONG, (32768, 320): tgeglu.FWD_PINGPONG,
            (1024, 1280): tgeglu.FWD_NARROW, (512, 1280): tgeglu.FWD_NARROW}
    for m, d in K4_PATH:
        assert tgeglu.fwd_tile(m, d, 4 * d) == want.get((m, d), tgeglu.FWD_WIDE)
    for m in (64, 128, 300, 1000, 4096, 9000, 32768):
        for d, inner in ((640, 2560), (1280, 5120), (48, 100), (640, 64)):
            wide_tiles = -(-m // 128) * -(-inner // 128)
            if wide_tiles >= 4 * 132:
                assert tgeglu.fwd_tile(m, d, inner) == tgeglu.FWD_WIDE

    def busiest(m, inner, tile):
        _, per_block = _k4_schedule(m, inner, tile)
        return max(per_block) * tile[1]

    assert busiest(1024, 5120, tgeglu.FWD_NARROW) / busiest(1024, 5120, tgeglu.FWD_WIDE) == pytest.approx(320 / 384)
    assert busiest(512, 5120, tgeglu.FWD_NARROW) / busiest(512, 5120, tgeglu.FWD_WIDE) == 0.75
    assert busiest(256, 5120, tgeglu.FWD_NARROW) == busiest(256, 5120, tgeglu.FWD_WIDE) == 128
