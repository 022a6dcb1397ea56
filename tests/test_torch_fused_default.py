"""Which path a NeRF takes when the caller leaves ``fused`` unset: the
port's rule (``render/raycaster.py::resolve_fused``) and ``Raycaster``,
on the CPU.

The fused kernels are on by default only for a NeRF on a CUDA device
in bf16; in f32 a whole fused train step did not beat the plain one in
every turn on an H100 (PERF.md, section 5). An explicit ``--fused`` /
``--no-fused`` always wins. A
stand-in model whose parameters say they are on a card lets the CPU
check the CUDA side of the rule."""

from types import SimpleNamespace

import pytest
import torch

from fourier_feature_nets_torch.cli import train_nerf
from fourier_feature_nets_torch.models import NeRF
from fourier_feature_nets_torch.render import Raycaster
from fourier_feature_nets_torch.render.raycaster import resolve_fused

SMALL = dict(num_layers=2, num_channels=32, max_log_scale_pos=4.0,
             num_freq_pos=3, max_log_scale_view=2.0, num_freq_view=2,
             skips=[], include_inputs=True)


class _StandIn:
    """Enough of a model for ``Raycaster.__init__``: a type and one
    parameter that says where it lies."""

    def __init__(self, model_type="nerf", is_cuda=True):
        self.model_type = model_type
        self._param = SimpleNamespace(is_cuda=is_cuda)

    def parameters(self):
        yield self._param


@pytest.mark.parametrize("requested", [None, True, False])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("on_cuda", [False, True], ids=["cpu", "cuda"])
def test_resolve_fused(on_cuda, dtype, requested):
    expected = requested if requested is not None else (
        on_cuda and dtype == torch.bfloat16)
    assert resolve_fused(requested, on_cuda, dtype) is expected


@pytest.mark.parametrize("dtype, expected", [(None, False),
                                             (torch.float32, False),
                                             (torch.bfloat16, True)])
def test_raycaster_default_on_cuda_follows_the_dtype(dtype, expected):
    caster = Raycaster(_StandIn(), compute_dtype=dtype)
    assert caster.fused is expected and caster.fused_train is expected


@pytest.mark.parametrize("forced", [True, False])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_raycaster_honours_an_explicit_choice(dtype, forced):
    caster = Raycaster(_StandIn(), compute_dtype=dtype, fused=forced,
                       fused_train=forced)
    assert caster.fused is forced and caster.fused_train is forced
    mixed = Raycaster(_StandIn(), compute_dtype=dtype, fused=forced,
                      fused_train=not forced)
    assert mixed.fused is forced and mixed.fused_train is (not forced)


def test_raycaster_never_fuses_a_model_that_is_not_a_nerf():
    caster = Raycaster(_StandIn(model_type="voxels"),
                       compute_dtype=torch.bfloat16, fused=True,
                       fused_train=True)
    assert not caster.fused and not caster.fused_train


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_raycaster_on_the_cpu(dtype):
    """A real NeRF on the CPU: plain by default in either dtype, and
    True still routes it through the kernels' twins."""
    model = NeRF(**SMALL, generator=torch.Generator().manual_seed(0))
    default = Raycaster(model, compute_dtype=dtype)
    assert not default.fused and not default.fused_train
    forced = Raycaster(model, compute_dtype=dtype, fused=True,
                       fused_train=True)
    assert forced.fused and forced.fused_train


def test_train_nerf_cli_leaves_fused_unset_by_default():
    """The CLI passes ``--fused`` / ``--no-fused`` through and None
    otherwise, so its f32 default resolves to the plain path."""
    assert train_nerf._parse_args(["synthetic", "out"]).fused is None
    assert train_nerf._parse_args(["synthetic", "out"]).compute_dtype == \
        "float32"
    assert train_nerf._parse_args(["synthetic", "out", "--fused"]).fused
    assert train_nerf._parse_args(["synthetic", "out",
                                   "--no-fused"]).fused is False
