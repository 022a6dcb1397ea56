"""The int8 probe's plain twins (P1a-c) against the JAX tool's Pallas
kernels in interpret mode on the CPU, the wrappers' CPU contract, and
the probe CLI on the CPU twins. The Hopper kernels themselves are held
against the twins on a card by tests/test_torch_kernel_cuda.py.

The kernel bodies sit inside ``tools/int8_probe.py::main`` and cannot
be imported, so each is copied here with the line it comes from."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fourier_feature_nets_torch.cli import int8_probe as cli
from fourier_feature_nets_torch.kernels import int8_probe as probe


def _dot(a, b, acc_t):
    return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                               preferred_element_type=acc_t)


def k_int8(w_ref, h_ref, o_ref):
    """tools/int8_probe.py:31-34"""
    o_ref[:] = _dot(w_ref[:], h_ref[:], jnp.int32)


def k_quant(x_ref, w_ref, o_ref):
    """tools/int8_probe.py:63-70"""
    x = x_ref[:]
    scale = jnp.max(jnp.abs(x)) / 127.0 + 1e-30
    q = jnp.round(x / scale).astype(jnp.int8)
    acc = _dot(w_ref[:], q, jnp.int32)
    o_ref[:] = acc.astype(jnp.float32) * scale


def stack_kernel(dtype, acc_t):
    """tools/int8_probe.py:99-111"""
    def kern(h_ref, *w_refs):
        out_ref = w_refs[-1]
        h = h_ref[:]
        for w_ref in w_refs[:-1]:
            acc = _dot(w_ref[:], h, acc_t)
            h = jnp.maximum(acc, 0).astype(dtype)
        out_ref[:] = h.astype(jnp.float32)
    return kern


def _pallas(kernel, shape, dtype, *args):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(shape, dtype),
        interpret=True)(*map(jnp.asarray, args)))


def _probe_inputs(m=128, k=128, n=256, seed=0):
    """The tool's stage 1-2b inputs (:36-38, :73), at its shapes by
    default."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, (m, k), dtype=np.int8)
    h = rng.integers(-127, 128, (k, n), dtype=np.int8)
    x = rng.normal(size=(k, n)).astype(np.float32)
    return w, h, x


@pytest.mark.parametrize("shape", [(128, 128, 256), (20, 37, 9)])
def test_int8_matmul_twin_matches_pallas_exactly(shape):
    w, h, _ = _probe_inputs(*shape)
    ref = _pallas(k_int8, (shape[0], shape[2]), jnp.int32, w, h)
    ours = probe.int8_matmul_reference(torch.from_numpy(w),
                                       torch.from_numpy(h))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ref, w.astype(np.int32) @ h.astype(np.int32))


@pytest.mark.parametrize("shape", [(128, 128, 256), (20, 37, 9)])
def test_quantized_matmul_twin_matches_pallas_exactly(shape):
    """Round half to even and an IEEE division, as jnp.round and XLA's
    divide: the twin equals the interpreted kernel bit for bit."""
    w, _, x = _probe_inputs(*shape)
    ref = _pallas(k_quant, (shape[0], shape[2]), jnp.float32, x, w)
    ours = probe.quantized_matmul_reference(torch.from_numpy(x),
                                            torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


def test_quantized_matmul_rounds_half_to_even():
    """x = k/2 * scale with scale = 1 (max|x| = 127 - 1e-30 rounds to
    127): the halves go to the even integer, as jnp.round does."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]], np.float32).T
    w = np.ones((1, 6), np.int8)
    got = probe.quantized_matmul_reference(torch.from_numpy(x),
                                           torch.from_numpy(w)).item()
    ref = _pallas(k_quant, (1, 1), jnp.float32, x, w).item()
    assert got == ref == 127 + 0 + 2 + 2 - 0 - 2


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_layer_stack_twin_matches_pallas(dtype):
    """32 channels x 64 columns, 3 layers, the tool's value ranges: the
    first layer's sums reach past 127, so the int8 cast wraps. Both
    dtypes match exactly: every product is an integer and every sum
    stays under 2**24 (the largest |sum| is 40,161), so the order of the
    f32 sums cannot matter."""
    rng = np.random.default_rng(1)
    channels, columns, layers = 32, 64, 3
    ws = rng.integers(-5, 6, (layers, channels, channels))
    h0 = rng.integers(0, 6, (channels, columns))
    jdt, acc, tdt = {"int8": (jnp.int8, jnp.int32, torch.int8),
                     "bf16": (jnp.bfloat16, jnp.float32,
                              torch.bfloat16)}[dtype]
    ref = np.asarray(pl.pallas_call(
        stack_kernel(jdt, acc),
        out_shape=jax.ShapeDtypeStruct((channels, columns), jnp.float32),
        interpret=True)(jnp.asarray(h0, jdt),
                        *[jnp.asarray(w, jdt) for w in ws]))
    ours = probe.layer_stack_reference(
        torch.from_numpy(h0).to(tdt), torch.from_numpy(ws).to(tdt)).numpy()
    np.testing.assert_array_equal(ours, ref)
    first = np.maximum(ws[0] @ h0, 0)
    assert first.max() > 127
    if dtype == "int8":
        assert (ref < 0).any()      # wrapped values carried on


def test_int8_cast_wraps_like_xla():
    acc = np.array([300, 128, 127, 0, -5, 256 + 3], np.int32)
    ref = np.asarray(jnp.maximum(jnp.asarray(acc), 0).astype(jnp.int8))
    ours = torch.clamp_min(torch.from_numpy(acc), 0).to(torch.int8).numpy()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, [44, -128, 127, 0, 0, 3])


def test_cpu_wrappers_run_twins_without_counting():
    w, h, x = (torch.from_numpy(a) for a in _probe_inputs(16, 16, 32))
    ws = w[None, :, :16].clone()
    before = (probe.int8_matmul.launches, probe.quantized_matmul.launches,
              probe.layer_stack.launches)
    assert torch.equal(probe.int8_matmul(w, h),
                       probe.int8_matmul_reference(w, h))
    assert torch.equal(probe.quantized_matmul(x, w),
                       probe.quantized_matmul_reference(x, w))
    assert torch.equal(probe.layer_stack(h[:16].clone(), ws),
                       probe.layer_stack_reference(h[:16].clone(), ws))
    assert (probe.int8_matmul.launches, probe.quantized_matmul.launches,
            probe.layer_stack.launches) == before


def test_wrappers_reject_other_devices():
    meta = torch.empty(4, 4, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no int8 matmul kernel"):
        probe.int8_matmul(meta, meta)
    with pytest.raises(ValueError, match="no quantized matmul kernel"):
        probe.quantized_matmul(meta.float(), meta)
    with pytest.raises(ValueError, match="no layer stack kernel"):
        probe.layer_stack(meta, meta[None])


@pytest.mark.parametrize("bad", ["dtype", "dims", "strided", "empty"])
def test_input_checks(bad):
    tensor = torch.zeros(4, 8, dtype=torch.int8)
    if bad == "dtype":
        tensor = tensor.float()
    elif bad == "dims":
        tensor = tensor[None]
    elif bad == "strided":
        tensor = torch.zeros(8, 4, dtype=torch.int8).T
    else:
        tensor = tensor[:0]
    with pytest.raises(ValueError, match="contiguous non-empty"):
        probe._check(tensor.device, ("w", tensor, torch.int8, 2))


# ---------------------------------------------------------------------------
# the probe CLI on the CPU twins
# ---------------------------------------------------------------------------


def test_cli_runs_every_stage_on_cpu_twins(capsys):
    assert cli.main(["--device", "cpu", "--columns", "64",
                     "--steps", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:3] == ["stage1 OK: int8 dot kernel compiled and ran",
                         "stage2 OK: exact int32 numerics",
                         "stage2b OK: quantize+dot+dequant kernel runs, "
                         "max rel err vs numpy 0.00e+00"]
    for line, name in zip(lines[3:5], ("bf16", "int8")):
        assert re.fullmatch(rf"stage3 {name}: [0-9.]+ us/call, "
                            rf"[0-9.]+ T\(op\)/s", line), line
    assert re.fullmatch(r"stage3 ratio: int8 is [0-9.]+x bf16", lines[5])
    assert len(lines) == 6


def test_cli_stage3_inputs_follow_the_tool():
    """Weights first, each layer in [-5, 5], then h0 in [0, 5], as
    integers cast to the stage's type."""
    ws, h0 = cli.stage3_inputs(np.random.default_rng(0), torch.int8, 16,
                               "cpu")
    assert ws.shape == (cli.LAYERS, cli.CHANNELS, cli.CHANNELS)
    assert h0.shape == (cli.CHANNELS, 16)
    assert ws.min() == -5 and ws.max() == 5
    assert h0.min() == 0 and h0.max() == 5


def test_cli_fails_a_stage_and_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(cli, "int8_matmul",
                        lambda w, h: probe.int8_matmul_reference(w, h) + 1)
    assert cli.main(["--device", "cpu", "--columns", "16",
                     "--steps", "1"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["stage1 OK: int8 dot kernel compiled and ran",
                     "stage2 FAIL: numerics off, max abs err 1"]


def test_cli_refuses_a_missing_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
