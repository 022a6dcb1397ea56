"""The IO-floor copy kernels' plain twins (P3a-c) against copies of the
JAX tool's Pallas kernels in interpret mode on the CPU, the sweep's
small models (the port's fused forward twin against the JAX package's),
the wrappers' CPU contract, and the IO-floor CLI on the CPU twins. The
Hopper kernels themselves are held against the twins on a card by
tests/test_torch_kernel_cuda.py.

The kernel bodies sit inside ``tools/kernel_io_floor_bench.py::main``
and cannot be imported, so each is copied here with the line it comes
from."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fourier_feature_nets_torch.cli import kernel_io_floor_bench as cli
from fourier_feature_nets_torch.kernels import io_floor as io
from fourier_feature_nets_torch.kernels.fused_nerf import (
    fused_nerf_reference,
    prepare_fused_nerf as port_prepare,
)
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.ops.fused_nerf import (
    fused_nerf_apply,
    prepare_fused_nerf,
)

N, TILE = 256, 64


def io_kernel(p_ref, v_ref, out_ref):
    """tools/kernel_io_floor_bench.py:142-144"""
    out_ref[:] = jnp.concatenate([p_ref[:], v_ref[:, :1]], -1)


def io_wide_kernel(x_ref, out_ref):
    """tools/kernel_io_floor_bench.py:165-166"""
    out_ref[:] = x_ref[:] * 2.0


def p8_kernel(x_ref, out_ref):
    """tools/kernel_io_floor_bench.py:185-188"""
    x = x_ref[:]
    out_ref[:] = jnp.concatenate([x[:, :3], x[:, 3:4], x[:, :4] * 0.0], -1)


def _tool_call(kernel, widths, out_width, *args):
    """The tool's grid and block specs (:136-138), interpreted."""
    def spec(w):
        return pl.BlockSpec((TILE, w), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)

    return np.asarray(pl.pallas_call(
        kernel, grid=(N // TILE,), in_specs=[spec(w) for w in widths],
        out_specs=spec(out_width),
        out_shape=jax.ShapeDtypeStruct((N, out_width), jnp.float32),
        interpret=True)(*map(jnp.asarray, args)))


def _normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_io_narrow_twin_matches_the_tool_kernel_bitwise():
    pos, views = _normal(N, 3), _normal(N, 3, seed=1)
    ref = _tool_call(io_kernel, (3, 3), 4, pos, views)
    ours = io.io_narrow_reference(torch.from_numpy(pos),
                                  torch.from_numpy(views)).numpy()
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


def test_io_wide_twin_matches_the_tool_kernel_bitwise():
    x = _normal(N, 128)
    ref = _tool_call(io_wide_kernel, (128,), 128, x)
    ours = io.io_wide_reference(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


def test_packed8_twin_matches_the_tool_kernel_bitwise():
    """x[:, :4] * 0 keeps the sign of a zero and turns inf into NaN, in
    both."""
    x = _normal(N, 8)
    x[0, :4] = [np.inf, -1.0, 0.0, -0.0]
    ref = _tool_call(p8_kernel, (8,), 8, x)
    ours = io.packed8_reference(torch.from_numpy(x)).numpy()
    assert np.isnan(ref[0, 4]) and np.isnan(ours[0, 4])
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(_bits(ours)[finite], _bits(ref)[finite])
    np.testing.assert_array_equal(_bits(ours[1:]), _bits(ref[1:]))
    assert np.signbit(ours[0, 5]) and not np.signbit(ours[0, 6])


def test_cpu_wrappers_run_twins_without_counting():
    pos, views = torch.from_numpy(_normal(10, 3)), torch.from_numpy(
        _normal(10, 3, seed=1))
    wide, packed = torch.from_numpy(_normal(10, 128)), torch.from_numpy(
        _normal(10, 8))
    before = (io.io_narrow.launches, io.io_wide.launches, io.packed8.launches)
    assert torch.equal(io.io_narrow(pos, views, 4),
                       io.io_narrow_reference(pos, views))
    assert torch.equal(io.io_wide(wide), io.io_wide_reference(wide))
    assert torch.equal(io.packed8(packed), io.packed8_reference(packed))
    assert (io.io_narrow.launches, io.io_wide.launches,
            io.packed8.launches) == before


def test_wrappers_reject_other_devices():
    meta = torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError, match="no io-narrow kernel"):
        io.io_narrow(meta, meta)
    with pytest.raises(ValueError, match="no io-wide kernel"):
        io.io_wide(torch.empty(8, 128, device="meta"))
    with pytest.raises(ValueError, match="no packed8 kernel"):
        io.packed8(torch.empty(8, 8, device="meta"))


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "strided",
                                 "empty", "misaligned", "tile"])
def test_input_checks(bad):
    a, b, tile = torch.zeros(8, 3), torch.zeros(8, 3), 4
    if bad == "dtype":
        b = b.double()
    elif bad == "width":
        b = torch.zeros(8, 4)
    elif bad == "rows":
        b = torch.zeros(9, 3)
    elif bad == "strided":
        b = torch.zeros(3, 8).T
    elif bad == "empty":
        a, b = a[:0], b[:0]
    elif bad == "misaligned":
        b = torch.zeros(8 * 3 + 1)[1:].view(8, 3)
    else:
        tile = 0
    with pytest.raises(ValueError):
        io._check([("positions", a), ("views", b)],
                  {"positions": 3, "views": 3}, tile)


def test_checks_pass_good_inputs():
    assert io._check([("x", torch.zeros(5, 8))], {"x": 8}, 2048) == 5
    assert io._check([("x", torch.zeros(5, 128))], {"x": 128}) == 5


# ---------------------------------------------------------------------------
# the sweep's models through the fused forward's twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row", cli.SWEEP[1:],
                         ids=[f"{l}x{c}_f{p}_{v}" for l, c, p, v in
                              cli.SWEEP[1:]])
def test_sweep_model_twin_matches_jax_fused_forward(row):
    """The small models of the sweep (4x128 skip 2, its f6/2 encode,
    2x64 skip 1) built from the CLI's arguments: the port's fused forward
    twin against the JAX package's kernel, bf16 as the sweep runs it."""
    config = cli.sweep_config(*row)
    model = NeRF(**config)
    params = model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    weights = port_prepare(params_from_jax(TorchNeRF(**config), flat),
                           torch.bfloat16)
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(300, 3)).astype(np.float32)
    views = rng.normal(size=(300, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    ref = fused_nerf_apply(model, prepare_fused_nerf(model, params,
                                                     dtype=jnp.bfloat16),
                           jnp.asarray(pos), jnp.asarray(views), tile=128,
                           interpret=True)
    with torch.no_grad():
        ours = fused_nerf_reference(weights, torch.from_numpy(pos),
                                    torch.from_numpy(views)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0,
                               atol=cli.BF16_ATOL)


def test_sweep_configs_follow_the_tool():
    assert cli.SWEEP == ((8, 256, 10, 4), (4, 128, 10, 4), (4, 128, 6, 2),
                         (2, 64, 10, 4))
    assert [cli.sweep_config(*row)["skips"] for row in cli.SWEEP] == \
        [[4], [2], [2], [1]]
    model = cli.sweep_model(4, 128, 6, 2)
    assert model.num_pos_encoded == 39 and model.num_view_encoded == 15


# ---------------------------------------------------------------------------
# the IO-floor CLI on the CPU twins
# ---------------------------------------------------------------------------


ROW = r" *: +[0-9.]+ ms \( *[0-9.]+ Mrows/s\)"


def test_cli_runs_every_row_on_cpu_twins(capsys):
    assert cli.main(["--device", "cpu", "--rays", "4", "--samples", "8",
                     "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    labels = [f"kernel {l}x{c} f{p}/{v}" for l, c, p, v in cli.SWEEP]
    labels += ["io-narrow t2048", "io-narrow t4096", "io-wide", "packed8"]
    rows = lines[:4] + lines[5:]
    assert len(lines) == 9 and len(rows) == len(labels)
    for line, label in zip(rows, labels):
        assert line.startswith(f"{label:18s}:"), line
        assert re.fullmatch(re.escape(label) + ROW, line), line
    assert lines[4] == (f"{'kernel-fm':18s}: the port has one layout; these "
                        f"rows are the kernel rows above")


def test_cli_reports_a_failed_row_and_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(cli, "packed8", lambda x: io.packed8_reference(x) + 1)
    assert cli.main(["--device", "cpu", "--rays", "2", "--samples", "4",
                     "--reps", "1"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 9
    assert lines[-1].startswith(f"{'packed8':18s}: FAILED AssertionError")
    assert not any("FAILED" in line for line in lines[:-1])


def test_cli_refuses_a_missing_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
