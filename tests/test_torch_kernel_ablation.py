"""The fused NeRF ablation's plain twin (P2) against a copy of the JAX
tool's Pallas kernel in interpret mode on the CPU, ``base`` against the
JAX package's fused forward, the wrapper's CPU contract, and the
ablation CLI on the CPU twins. The Hopper kernel itself is held against
the twin on a card by tests/test_torch_kernel_cuda.py.

The model is an 8x32 NeRF with a skip at 4 and raw inputs: the
flagship's structure (the tool's kernel is written for it) at a width
that keeps interpret mode quick."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fourier_feature_nets_torch.cli import kernel_ablation_bench as cli
from fourier_feature_nets_torch.kernels import fused_nerf_ablation as ablation
from fourier_feature_nets_torch.kernels.fused_nerf import (
    fused_nerf_reference,
    prepare_fused_nerf as port_prepare,
)
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.ops.fused_nerf import (
    _fast_sincos,
    _phases,
    fused_nerf_apply,
    prepare_fused_nerf,
)

FLAGSHIP_SHAPED = dict(num_layers=8, num_channels=32, max_log_scale_pos=9.0,
                       num_freq_pos=10, max_log_scale_view=3.0,
                       num_freq_view=4, skips=[4], include_inputs=True)
TILE = 64
# tests/test_fused_nerf.py:64; every mode reads 0.0 against the tool's
# kernel on the CPU
BF16_ATOL = 0.05
# bf16-accum, max and mean |d| (chip_smoke.py, ACCUM_ATOL): it differs
# from base by rounding only, so base's twin lies within the max limit of
# the tool's bf16-accum and only the mean tells them apart
# (test_bf16_accum_limits_reject_base)
ACCUM_ATOL, ACCUM_MEAN_ATOL = 4e-3, 5e-6


def make_kernel(mode):
    """tools/kernel_ablation_bench.py:50-129, every mode it defines."""
    body_accum = (jnp.bfloat16 if mode == "bf16-accum"
                  else jnp.float32)

    def dot(a, w_ref, accum=jnp.float32):
        return jax.lax.dot_general(
            a, w_ref[:], (((1,), (0,)), ((), ())),
            preferred_element_type=accum)

    def kernel(positions_ref, views_ref, pos_enc_ref, view_enc_ref,
               fp0, fp1, fp2, first_b, m0, m1, m2, m3, m4, m5,
               mb0, mb1, mb2, mb3, mb4, mb5,
               sp0, sp1, sp2, sp3, sb0,
               opacity_w, opacity_b, bottleneck_w, bottleneck_b,
               hp0, hp1, hp2, hp3, hidden_b, color_w, color_b,
               out_ref):
        cd = jnp.bfloat16
        pos = positions_ref[:]
        if mode == "no-sincos":
            ph = _phases(pos, pos_enc_ref)
            enc = [ph.astype(cd), (ph * 0.5).astype(cd),
                   pos.astype(cd)]
        else:
            sin, cos = _fast_sincos(_phases(pos, pos_enc_ref))
            enc = [cos.astype(cd), sin.astype(cd), pos.astype(cd)]

        first = [fp0, fp1, fp2]

        def enc_dot(parts, accum):
            acc = dot(enc[0], parts[0], accum)
            for feat, w in zip(enc[1:], parts[1:]):
                acc += dot(feat, w, accum)
            return acc

        use_bias = mode not in ("no-bias", "matmul-only")
        use_relu = mode not in ("no-relu", "matmul-only")

        def post(acc, b):
            if use_bias:
                acc = acc + b[:].astype(acc.dtype)
            acc = acc.astype(cd)
            if use_relu:
                acc = jnp.maximum(acc, 0.0)
            return acc

        h = post(enc_dot(first, body_accum), first_b)
        mids = [m0, m1, m2, m3, m4, m5]
        mbs = [mb0, mb1, mb2, mb3, mb4, mb5]
        mid_iter = 0
        for i in range(1, 8):
            if i == 4:
                acc = (dot(h, sp0, body_accum)
                       + enc_dot([sp1, sp2, sp3], body_accum))
                h = post(acc, sb0)
            else:
                acc = dot(h, mids[mid_iter], body_accum)
                h = post(acc, mbs[mid_iter])
                mid_iter += 1

        opacity = dot(h, opacity_w) + opacity_b[:]
        bottleneck = (dot(h, bottleneck_w)
                      + bottleneck_b[:]).astype(cd)

        if mode == "no-view":
            color = opacity * 0.0 + color_b[:]
        else:
            v = views_ref[:]
            v_sin, v_cos = _fast_sincos(_phases(v, view_enc_ref))
            venc = [v_cos.astype(cd), v_sin.astype(cd),
                    v.astype(cd)]
            acc = dot(bottleneck, hp0)
            for feat, w in zip(venc, [hp1, hp2, hp3]):
                acc += dot(feat, w)
            hidden = jnp.maximum(acc + hidden_b[:], 0.0).astype(cd)
            color = dot(hidden, color_w) + color_b[:]

        out_ref[:] = jnp.concatenate(
            [color[:, :3], opacity[:, :1]], -1)

    return kernel


def tool_ablation(weights, pos, views, mode):
    """The tool's pallas_call (:131-161), interpreted, tile TILE."""
    weight_inputs = (list(weights.first_parts) + [weights.first_b]
                     + list(weights.mid_w) + list(weights.mid_b)
                     + list(weights.skip_parts[0]) + list(weights.skip_b)
                     + [weights.opacity_w, weights.opacity_b,
                        weights.bottleneck_w, weights.bottleneck_b]
                     + list(weights.hidden_parts)
                     + [weights.hidden_b, weights.color_w,
                        weights.color_b])

    def const_spec(shape):
        return pl.BlockSpec(shape, lambda i: (0,) * len(shape),
                            memory_space=pltpu.VMEM)

    in_specs = [
        pl.BlockSpec((TILE, 3), lambda i: (i, 0), memory_space=pltpu.VMEM),
        pl.BlockSpec((TILE, 3), lambda i: (i, 0), memory_space=pltpu.VMEM),
        const_spec(weights.pos_enc.shape),
        const_spec(weights.view_enc.shape),
    ] + [const_spec(w.shape) for w in weight_inputs]
    n = pos.shape[0]
    return np.asarray(pl.pallas_call(
        make_kernel(mode), grid=(n // TILE,), in_specs=in_specs,
        out_specs=pl.BlockSpec((TILE, 4), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, 4), jnp.float32),
        interpret=True)(jnp.asarray(pos), jnp.asarray(views),
                        weights.pos_enc, weights.view_enc, *weight_inputs))


@pytest.fixture(scope="module")
def nerf():
    model = NeRF(**FLAGSHIP_SHAPED)
    params = model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    torch_model = params_from_jax(TorchNeRF(**FLAGSHIP_SHAPED), flat)
    return model, prepare_fused_nerf(model, params, dtype=jnp.bfloat16), \
        port_prepare(torch_model, torch.bfloat16)


@pytest.fixture(scope="module")
def points():
    """The tool's points (:36-42) for 4 rays x 32 samples, seeded."""
    pos, views = cli.ablation_inputs(4, 32, "cpu")
    return pos.numpy(), views.numpy()


def _twin(weights, points, mode):
    pos, views = points
    with torch.no_grad():
        return ablation.fused_nerf_ablation_reference(
            weights, torch.from_numpy(pos), torch.from_numpy(views),
            mode).numpy()


def _assert_accum_close(ours, ref):
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ACCUM_ATOL)
    assert np.abs(ours - ref).mean() <= ACCUM_MEAN_ATOL


@pytest.mark.parametrize("mode", ablation.ALL_MODES)
def test_twin_matches_the_tool_kernel(nerf, points, mode):
    _, jax_weights, weights = nerf
    ref = tool_ablation(jax_weights, *points, mode)
    ours = _twin(weights, points, mode)
    assert ours.shape == ref.shape == (points[0].shape[0], 4)
    if mode == "bf16-accum":
        _assert_accum_close(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=BF16_ATOL)


def test_bf16_accum_limits_reject_base(nerf, points):
    """base's twin passes bf16-accum's max-error limits against the
    tool's bf16-accum kernel but not its mean one."""
    _, jax_weights, weights = nerf
    ref = tool_ablation(jax_weights, *points, "bf16-accum")
    base = _twin(weights, points, "base")
    np.testing.assert_allclose(base, ref, rtol=0, atol=ACCUM_ATOL)
    with pytest.raises(AssertionError):
        _assert_accum_close(base, ref)


def test_base_matches_the_jax_fused_forward(nerf, points):
    model, jax_weights, weights = nerf
    pos, views = points
    ref = np.asarray(fused_nerf_apply(model, jax_weights, jnp.asarray(pos),
                                      jnp.asarray(views), tile=TILE,
                                      interpret=True))
    np.testing.assert_allclose(_twin(weights, points, "base"), ref, rtol=0,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_base_twin_is_the_forward_twin(nerf, points, dtype):
    model_weights = nerf[2]
    if dtype == torch.float32:
        torch_model = TorchNeRF(**FLAGSHIP_SHAPED,
                                generator=torch.Generator().manual_seed(2))
        model_weights = port_prepare(torch_model, dtype)
    pos, views = map(torch.from_numpy, points)
    with torch.no_grad():
        assert torch.equal(
            ablation.fused_nerf_ablation_reference(model_weights, pos, views,
                                                   "base"),
            fused_nerf_reference(model_weights, pos, views))


def test_each_mode_changes_what_it_names(nerf, points):
    """Every mode differs from base; no-view leaves the opacity alone
    and sets every row's color to the color head's bias."""
    weights = nerf[2]
    base = _twin(weights, points, "base")
    outs = {mode: _twin(weights, points, mode)
            for mode in ablation.ALL_MODES}
    for mode in ablation.ALL_MODES[1:]:
        assert not np.array_equal(outs[mode], base), mode
    np.testing.assert_array_equal(outs["no-view"][:, 3], base[:, 3])
    color_b = weights.layers[weights.num_layers + 3][1][:3].numpy()
    np.testing.assert_array_equal(outs["no-view"][:, :3],
                                  np.broadcast_to(color_b, (len(base), 3)))


def test_no_sincos_encodes_phases(nerf, points):
    """no-sincos feeds the body [phase | phase * 0.5 | raw] in place of
    [cos | sin | raw]."""
    weights = nerf[2]
    pos = torch.from_numpy(points[0])
    parts = ablation._pos_parts(weights, pos, "no-sincos", torch.float32)
    phases = pos @ weights.pos_enc
    torch.testing.assert_close(parts[0], phases, rtol=1e-6, atol=1e-5)
    assert torch.equal(parts[1], parts[0] * 0.5)
    assert torch.equal(parts[2], pos)
    sin_cos = ablation._pos_parts(weights, pos, "base", torch.float32)
    assert not torch.allclose(sin_cos[0], parts[0])


def test_bf16_accum_stays_near_base(nerf, points):
    """bf16-accum rounds one more time in each body layer than base, so
    it differs from base by rounding only; its body activations are
    bf16 after the ReLU. (Where it rounds is held by the tool's kernel
    above.)"""
    weights = nerf[2]
    base = _twin(weights, points, "base")
    accum = _twin(weights, points, "bf16-accum")
    assert not np.array_equal(accum, base)
    np.testing.assert_allclose(accum, base, rtol=0, atol=ACCUM_ATOL)
    pos = torch.from_numpy(points[0])
    parts = ablation._pos_parts(weights, pos, "bf16-accum", torch.bfloat16)
    h = ablation._bf16_body(None, parts, weights.layers[0])
    assert h.dtype == torch.bfloat16 and (h >= 0).all()


# bf16-accum's slab image (accum_slab_image): where the kernel reads each
# weight, decoded here independently of the index that built it

NO_RAW = dict(num_layers=4, num_channels=64, max_log_scale_pos=9.0,
              num_freq_pos=6, max_log_scale_view=3.0, num_freq_view=4,
              skips=[2], include_inputs=False)


def _decode_slabs(image, k_dim, n_dim):
    """The (k_dim, n_dim) matrix stored as 64-row slabs of n_dim rows of
    64 values, 16-byte chunk q of row n at chunk q ^ (n % 8); and the
    values past k_dim in the last slab, which must be zeros."""
    slabs = -(-k_dim // 64)
    rows = image[:slabs * n_dim * 64].reshape(slabs, n_dim, 8, 8)
    chunk = (np.arange(8)[None, :] ^ (np.arange(n_dim)[:, None] % 8))
    logical = np.take_along_axis(rows, chunk[None, :, :, None], axis=2)
    full = logical.reshape(slabs, n_dim, 64).transpose(0, 2, 1).reshape(
        slabs * 64, n_dim)
    return full[:k_dim], full[k_dim:], image[slabs * n_dim * 64:]


def _accum_expected(weights, layer):
    """The (rows, C) matrices bf16-accum's layer reads, part by part: cos,
    sin (and raw), each zero past its values to a multiple of 16 rows,
    in layer 0 and the skip layers; then h's C rows."""
    w = weights.layers[layer][0].float().numpy()
    channels = weights.channels
    e_pos = weights.pos_enc.shape[1]
    parts, _ = ablation.accum_parts(e_pos, weights.include_inputs)
    blocks = []
    if layer == 0 or layer in weights.skips:
        first_row = 0 if layer == 0 else channels
        for (_, length), first in zip(parts, (0, e_pos, 2 * e_pos)):
            run = np.zeros((-(-length // 16) * 16, channels), np.float32)
            run[:length] = w[first_row + first:first_row + first + length]
            blocks.append(run)
    if layer > 0:
        blocks.append(w[:channels])
    return blocks


@pytest.mark.parametrize("e_pos, raw", [(30, True), (18, False), (16, True),
                                        (3, False)])
def test_accum_parts_start_on_k16_steps(e_pos, raw):
    parts, width = ablation.accum_parts(e_pos, raw)
    assert [length for _, length in parts] == [e_pos, e_pos] + [3] * raw
    ends = [offset for offset, _ in parts[1:]] + [width]
    for (offset, length), end in zip(parts, ends):
        assert offset % 16 == 0 and end - offset == -(-length // 16) * 16


@pytest.mark.parametrize("config", [FLAGSHIP_SHAPED, NO_RAW,
                                    dict(NO_RAW, num_channels=96)])
def test_accum_image_places_every_weight(config):
    """Each body layer is stored in pieces of accum_piece(C) output
    columns, each piece part by part, every part in slabs of its own;
    every packed weight lands where the kernel's products read it, the
    runs' padding and each part's last slab's tail are zeros, and the
    heads, bottleneck and hidden layer follow as in the pack's own slab
    image."""
    torch_model = TorchNeRF(**config,
                            generator=torch.Generator().manual_seed(4))
    weights = port_prepare(torch_model, torch.bfloat16)
    image = ablation.accum_slab_image(weights).float().numpy()
    channels = weights.channels
    width = ablation.accum_piece(channels)
    assert width == (64 if channels % 64 == 0 else 32)
    rest = image
    for layer in range(weights.num_layers):
        for first in range(0, channels, width):
            for expected in _accum_expected(weights, layer):
                part, tail, rest = _decode_slabs(rest, expected.shape[0],
                                                 width)
                np.testing.assert_array_equal(
                    part, expected[:, first:first + width])
                assert not tail.any()
    # what is left is the pack's slab image past its body layers
    body = sum(-(-w.shape[0] // 64) * channels * 64
               for w, _ in weights.layers[:weights.num_layers])
    np.testing.assert_array_equal(rest, weights.slabs.float().numpy()[body:])


def test_accum_image_reproduces_the_twin(nerf, points):
    """The kernel's bf16-accum arithmetic over the accum image: each
    16-aligned run of the position encode, and h, a part with its own
    slabs and its own f32 product rounded to bf16, the parts chained in
    bf16 in the image's order, then the bf16 bias and the ReLU. It is the
    twin's body (f32 products summed in another order)."""
    weights = nerf[2]
    pos, views = map(torch.from_numpy, points)
    channels = weights.channels
    e_pos = weights.pos_enc.shape[1]
    parts, width = ablation.accum_parts(e_pos, weights.include_inputs)
    cos_sin_raw = ablation._pos_parts(weights, pos, "bf16-accum",
                                      torch.bfloat16)
    runs = torch.zeros((pos.shape[0], width), dtype=torch.bfloat16)
    for (offset, length), part in zip(parts, cos_sin_raw):
        runs[:, offset:offset + length] = part
    image = ablation.accum_slab_image(weights).float().numpy()
    width = ablation.accum_piece(channels)
    rest, h = image, None
    for layer in range(weights.num_layers):
        pos_part = layer == 0 or layer in weights.skips
        inputs = [runs[:, offset:offset + -(-length // 16) * 16]
                  for offset, length in parts] if pos_part else []
        inputs += [h] if h is not None else []
        pieces = []
        for _ in range(0, channels, width):
            acc = None
            for x in inputs:   # one part: its own slabs, its own product
                w, _, rest = _decode_slabs(rest, x.shape[1], width)
                product = (x.float() @ torch.from_numpy(w)).to(
                    torch.bfloat16)
                acc = product if acc is None else acc + product
            pieces.append(acc)
        bias = weights.layers[layer][1].to(torch.bfloat16)
        h = torch.relu(torch.cat(pieces, -1) + bias)
    twin_h = ablation._bf16_body(None, cos_sin_raw, weights.layers[0])
    for layer in range(1, weights.num_layers):
        twin_h = ablation._bf16_body(
            twin_h, cos_sin_raw if layer in weights.skips else [],
            weights.layers[layer])
    np.testing.assert_allclose(h.float().numpy(), twin_h.float().numpy(),
                               rtol=0.02, atol=0.02)


def test_cpu_wrapper_runs_twin_without_counting(nerf, points):
    weights = nerf[2]
    pos, views = map(torch.from_numpy, points)
    before = ablation.fused_nerf_ablation.launches
    with torch.no_grad():
        for mode in ablation.ALL_MODES:
            assert torch.equal(
                ablation.fused_nerf_ablation(weights, pos, views, mode),
                ablation.fused_nerf_ablation_reference(weights, pos, views,
                                                       mode))
    assert ablation.fused_nerf_ablation.launches == before


def test_wrapper_rejects_unknown_modes_and_devices(nerf):
    weights = nerf[2]
    f32_weights = port_prepare(TorchNeRF(**FLAGSHIP_SHAPED), torch.float32)
    cpu = torch.zeros(4, 3)
    for fn in (ablation.fused_nerf_ablation,
               ablation.fused_nerf_ablation_reference):
        with pytest.raises(ValueError, match="unknown ablation mode"):
            fn(weights, cpu, cpu, "no-encode")
        with pytest.raises(ValueError, match="bf16-accum takes a bf16 pack"):
            fn(f32_weights, cpu, cpu, "bf16-accum")
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="no fused NeRF ablation kernel"):
        ablation.fused_nerf_ablation(weights, meta, meta, "base")


# ---------------------------------------------------------------------------
# the ablation CLI on the CPU twins
# ---------------------------------------------------------------------------


def test_cli_inputs_follow_the_tool():
    """Origin at zero, depths linspace(1, 4, S), unit directions; the
    views repeat each ray's direction over its samples."""
    pos, views = cli.ablation_inputs(3, 5, "cpu")
    assert pos.shape == views.shape == (15, 3)
    depth = pos.norm(dim=-1).reshape(3, 5)
    torch.testing.assert_close(depth, torch.linspace(1, 4, 5).expand(3, 5))
    torch.testing.assert_close(views.norm(dim=-1), torch.ones(15))
    torch.testing.assert_close(pos / depth.reshape(-1, 1), views)


def test_cli_runs_every_mode_on_cpu_twins(capsys):
    assert cli.main(["--device", "cpu", "--rays", "4", "--samples", "8",
                     "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == ("tile: the JAX tool's tile=2048 has no counterpart "
                        "here; the kernel is K1's own, on 128-point tiles")
    assert len(lines) == 1 + len(ablation.MODES)
    for line, mode in zip(lines[1:], ablation.MODES):
        assert re.fullmatch(rf"{mode:12s}: +[0-9.]+ ms \( *[0-9.]+ Mpts/s\)",
                            line), line


def test_cli_reports_a_failed_mode_and_exits_1(monkeypatch, capsys):
    def broken(weights, pos, views, mode):
        out = ablation.fused_nerf_ablation_reference(weights, pos, views,
                                                     mode)
        return out + (1.0 if mode == "no-relu" else 0.0)

    monkeypatch.setattr(cli, "fused_nerf_ablation", broken)
    assert cli.main(["--device", "cpu", "--rays", "2", "--samples", "4",
                     "--reps", "1"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    failed = [line for line in lines if "FAILED" in line]
    assert len(failed) == 1 and failed[0].startswith("no-relu     : FAILED")
    assert len(lines) == 1 + len(ablation.MODES)


def test_cli_refuses_a_missing_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
