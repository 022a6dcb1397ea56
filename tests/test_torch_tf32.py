"""The f32 kernels' 3xTF32 products on the CPU: the tf32 split, the f32
slab image the kernels stream (K1's forward slabs and K2's transposed
dX slabs), and a plain 3xTF32 emulation of the f32 twin against the JAX
package's Pallas kernel (interpret mode). The kernels themselves are
held against the twin on a card by tests/test_torch_kernel_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_feature_nets_torch.kernels import fused_nerf as port
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import flagship_nerf
from fourier_feature_nets_tpu.ops.fused_nerf import (
    fused_nerf_apply,
    prepare_fused_nerf,
)

from test_torch_fused_nerf import BASE, _inputs, _pair

# the JAX suite's f32 tolerance (tests/test_fused_nerf.py:44)
F32_RTOL, F32_ATOL = 1e-3, 2e-4
# a single tf32 product keeps ~11 bits of each operand, 3xTF32 ~22: against
# the JAX f32 reference the single-TF32 twin's max |d| must be at least this
# many times the 3xTF32 twin's (on the CPU: ~4e2 to ~2e3)
SINGLE_TF32_FACTOR = 50

CONFIGS = {
    "4x64": BASE,
    "flagship": dict(num_layers=8, num_channels=256, max_log_scale_pos=9.0,
                     num_freq_pos=10, max_log_scale_view=3.0,
                     num_freq_view=4, skips=[4], include_inputs=True),
    "2x32 no skip, no raw": dict(num_layers=2, num_channels=32,
                                 max_log_scale_pos=6.0, num_freq_pos=7,
                                 max_log_scale_view=2.0, num_freq_view=3,
                                 skips=[], include_inputs=False),
    "3x192": dict(num_layers=3, num_channels=192, max_log_scale_pos=6.0,
                  num_freq_pos=7, max_log_scale_view=2.0, num_freq_view=3,
                  skips=[1], include_inputs=True),
}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _special_values() -> torch.Tensor:
    """Random f32 values over every exponent, with ±0, subnormals, the
    largest finite values and ties of the tf32 rounding."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**31 - 1, 20_000, dtype=np.int64)
    bits = bits[(bits >> 23) != 255]             # finite
    signs = rng.integers(0, 2, bits.shape) << 31
    values = (bits | signs).astype(np.uint32).view(np.float32)
    extra = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, 1.17e-38,
                      3.4e38, -3.4e38, 1.0 + 2**-11, -(1.0 + 2**-11),
                      1.0 + 3 * 2**-11, 1.0 - 2**-12], np.float32)
    return torch.from_numpy(np.concatenate([values, extra]))


def test_tf32_split_is_exact_and_rounds_hi_to_nearest():
    x = _special_values()
    hi, lo = port.tf32_split(x)
    # hi + lo is x, bit for bit (but -0, where hi is -0 and lo, x - hi,
    # is +0, so that hi + lo is +0: equal, not the same bits)
    zero = x == 0
    assert torch.equal(_bits(hi + lo)[~zero], _bits(x)[~zero])
    assert (hi + lo)[zero].eq(0).all()
    assert torch.equal(_bits(hi)[zero], _bits(x)[zero])
    # hi is a tf32 value: the low 13 bits of its significand are zero
    assert not (_bits(hi) & 0x1FFF).any()
    # and the nearest one: |lo| <= half a tf32 step, 2^-11 |x| for normal x;
    # a tf32 subnormal step is 2^-136, so there the bound is 2^-137
    normal = x.abs() >= 2.0**-126
    assert (lo[normal].abs() <= 2.0**-11 * x[normal].abs()).all()
    assert (lo[~normal].abs() <= 2.0**-137).all()
    # ties round away from zero (cvt.rna)
    tie = torch.tensor([1.0 + 2**-11, -(1.0 + 2**-11), 1.0 + 3 * 2**-11])
    assert torch.equal(port.tf32_round(tie),
                       torch.tensor([1.0 + 2**-10, -(1.0 + 2**-10),
                                     1.0 + 2 * 2**-10]))
    # the part the products read for lo is a tf32 value too, within a
    # tf32 step of lo
    lo_t = port.tf32_round(lo)
    assert not (_bits(lo_t) & 0x1FFF).any()
    assert ((lo_t - lo).abs() <= 2.0**-11 * lo.abs() + 2.0**-137).all()


def _unswizzle(block: torch.Tensor, rows: int) -> torch.Tensor:
    """A (rows, 32) f32 block read as wgmma reads a 128-byte swizzled
    K-major operand: row n's 16-byte chunk q lies at chunk q ^ (n % 8).
    Returns (32, rows): K-row by column."""
    chunks = block.reshape(rows, 8, 4)
    n = torch.arange(rows)[:, None]
    logical = chunks[n, torch.arange(8)[None, :] ^ (n % 8)]
    return logical.reshape(rows, 32).T


def _decode_matrix(image: torch.Tensor, at: int, k: int, n: int):
    """The hi and lo (K, N) matrices of a slab part at float ``at``: ceil(K
    / 32) slabs, each in pieces of at most 128 rows, each piece its hi
    rows then its lo rows (csrc/fused_nerf_tf32.cuh). Returns (hi, lo,
    floats read)."""
    pieces = 2 if n > 128 else 1
    width = n // pieces
    slabs = -(-k // 32)
    hi = torch.zeros(slabs * 32, n)
    lo = torch.zeros(slabs * 32, n)
    pos = at
    for s in range(slabs):
        for q in range(pieces):
            for part in (hi, lo):
                block = image[pos:pos + width * 32]
                part[32 * s:32 * s + 32, q * width:(q + 1) * width] = \
                    _unswizzle(block, width)
                pos += width * 32
    assert torch.count_nonzero(hi[k:]) == 0 and torch.count_nonzero(lo[k:]) == 0
    return hi[:k], lo[:k], pos - at


@pytest.mark.parametrize("name", list(CONFIGS))
def test_f32_slab_image_decodes_to_the_pack(name):
    model = TorchNeRF(**CONFIGS[name],
                      generator=torch.Generator().manual_seed(2))
    weights = port.pack_fused_nerf(model, torch.float32)
    image = weights.slabs
    assert image.dtype == torch.float32 and not image.requires_grad
    layers = [w.detach() for w, _ in weights.layers]
    shapes = [tuple(w.shape) for w in layers]
    num, c = weights.num_layers, weights.channels
    pos = 0
    parts = [(j, layers[j]) for j in (*range(num), num + 1, num + 2)]
    # K2's dX operands: W^T of the first C rows, hidden, bottleneck, body
    # L-1 .. 1
    parts += [(j, layers[j][:c].T)
              for j in (num + 2, num + 1, *range(num - 1, 0, -1))]
    for _, w in parts:
        hi, lo, read = _decode_matrix(image, pos, *w.shape)
        pos += read
        # the image holds tf32 parts: hi the weight rounded, lo the rest
        assert torch.equal(hi, port.tf32_round(w))
        assert torch.equal(lo, port.tf32_round(w - hi))
    # the heads as they lie in the flat pack, exact
    for j in (num, num + 3):
        size = layers[j].numel()
        assert torch.equal(image[pos:pos + size], layers[j].reshape(-1))
        pos += size
    assert pos == image.numel()
    # read back through its index, the image's places are the flat (in,
    # out) weights: kind 0 (hi) and 1 (lo) both point at the weight
    index, kind = port.f32_slab_index(shapes, weights.meta[8:8 + len(shapes)])
    assert index.shape == kind.shape == (image.numel(),)
    flat = weights.weights.detach()
    gathered = torch.where(torch.from_numpy(index) >= 0,
                           flat[torch.from_numpy(np.maximum(index, 0))], 0.0)
    hi_part = torch.from_numpy(kind == 0)
    assert torch.equal(image[hi_part], port.tf32_round(gathered[hi_part]))
    assert set(np.unique(kind)) == {0, 1, 2}
    assert (kind == 0).sum() == (kind == 1).sum()


def test_f32_pack_image_is_rebuilt_from_the_live_weights():
    model = TorchNeRF(**BASE, generator=torch.Generator().manual_seed(4))
    first = port.pack_fused_nerf(model, torch.float32)
    with torch.no_grad():
        model.layers[1].weight.mul_(2.0)
    second = port.pack_fused_nerf(model, torch.float32)
    assert not torch.equal(first.slabs, second.slabs)
    assert torch.equal(second.slabs, port.f32_slab_image(
        second.weights.detach(), [tuple(w.shape) for w, _ in second.layers],
        second.meta[8:8 + second.num_layers + 4]))


@pytest.fixture(scope="module", params=["4x64", "flagship"])
def f32_pallas(request):
    """(torch f32 pack, positions, views, Pallas f32 logits)."""
    if request.param == "flagship":
        from fourier_feature_nets_tpu.models import flagship_nerf as jax_flag
        from fourier_feature_nets_tpu.models.serialization import _flatten
        from fourier_feature_nets_torch.models import params_from_jax
        import jax
        model = jax_flag()
        params = model.init(jax.random.PRNGKey(0))
        flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
        torch_model = params_from_jax(flagship_nerf(), flat)
        pos, views = _inputs(256)
    else:
        model, params, torch_model = _pair(BASE)
        pos, views = _inputs(512)
    jax_weights = prepare_fused_nerf(model, params, dtype=jnp.float32)
    ref = np.asarray(fused_nerf_apply(model, jax_weights, jnp.asarray(pos),
                                      jnp.asarray(views), tile=128,
                                      interpret=True))
    return (port.prepare_fused_nerf(torch_model, torch.float32),
            torch.from_numpy(pos), torch.from_numpy(views), ref)


def test_3xtf32_twin_matches_pallas(f32_pallas):
    weights, pos, views, ref = f32_pallas
    with torch.no_grad():
        ours = port.fused_nerf_reference(weights, pos, views,
                                         products="3xtf32").numpy()
    np.testing.assert_allclose(ours, ref, rtol=F32_RTOL, atol=F32_ATOL)


def test_single_tf32_twin_reads_worse_than_3xtf32(f32_pallas):
    weights, pos, views, ref = f32_pallas
    with torch.no_grad():
        three = port.fused_nerf_reference(weights, pos, views,
                                          products="3xtf32").numpy()
        one = port.fused_nerf_reference(weights, pos, views,
                                        products="tf32").numpy()
    three_err = np.abs(three - ref).max()
    one_err = np.abs(one - ref).max()
    assert one_err >= SINGLE_TF32_FACTOR * three_err, (one_err, three_err)


def test_twin_refuses_unknown_products(nerf_pack):
    pos = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="products"):
        port.fused_nerf_reference(nerf_pack, pos, pos, products="2xtf32")


@pytest.fixture(scope="module")
def nerf_pack():
    _, _, torch_model = _pair(BASE)
    return port.prepare_fused_nerf(torch_model, torch.float32)
