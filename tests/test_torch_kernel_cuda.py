"""The Hopper fused-NeRF kernel against its plain twin, on a CUDA card.

Every test here needs a card and skips without one (the kernel has no
CPU mode). The file imports no jax, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from fourier_feature_nets_torch.kernels import fused_nerf as port
from fourier_feature_nets_torch.models import NeRF, flagship_nerf
from fourier_feature_nets_torch.render import Raycaster, RaySampler

SMALL = dict(num_layers=4, num_channels=64, max_log_scale_pos=9.0,
             num_freq_pos=10, max_log_scale_view=3.0, num_freq_view=4,
             skips=[2], include_inputs=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(num, device, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.5, 1.5, (num, 3)).astype(np.float32)
    views = rng.normal(size=(num, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    return torch.from_numpy(pos).to(device), torch.from_numpy(views).to(device)


def _assert_matches_twin(weights, pos, views):
    before = port.fused_nerf_apply.launches
    with torch.no_grad():
        out = port.fused_nerf_apply(weights, pos, views)
        twin = port.fused_nerf_reference(weights, pos, views)
    torch.cuda.synchronize()
    assert port.fused_nerf_apply.launches == before + 1
    assert out.shape == (pos.shape[0], 4)
    if weights.weights.dtype == torch.float32:
        torch.testing.assert_close(out, twin, rtol=1e-3, atol=2e-4)
    else:
        torch.testing.assert_close(out, twin, rtol=0, atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("num", [1, 63, 1000, 4099])
def test_small_model_matches_twin(cuda, dtype, num):
    model = NeRF(**SMALL, generator=torch.Generator().manual_seed(1)).to(cuda)
    _assert_matches_twin(port.prepare_fused_nerf(model, dtype),
                         *_inputs(num, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("config", [
    dict(num_layers=2, num_channels=32, skips=[], include_inputs=False),
    dict(num_layers=3, num_channels=96, skips=[1, 2], include_inputs=True),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_structural_configs_match_twin(cuda, config, dtype):
    model = NeRF(max_log_scale_pos=6.0, num_freq_pos=7,
                 max_log_scale_view=2.0, num_freq_view=3, **config,
                 generator=torch.Generator().manual_seed(2)).to(cuda)
    _assert_matches_twin(port.prepare_fused_nerf(model, dtype),
                         *_inputs(777, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flagship_matches_twin(cuda, dtype):
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    _assert_matches_twin(port.prepare_fused_nerf(model, dtype),
                         *_inputs(50_001, cuda))


@pytest.mark.cuda
def test_empty_batch_launches_nothing(cuda):
    model = NeRF(**SMALL).to(cuda)
    weights = port.prepare_fused_nerf(model, torch.bfloat16)
    pos = torch.zeros(0, 3, device=cuda)
    before = port.fused_nerf_apply.launches
    out = port.fused_nerf_apply(weights, pos, pos)
    assert out.shape == (0, 4)
    assert port.fused_nerf_apply.launches == before


@pytest.mark.cuda
def test_mixed_devices_raise(cuda):
    model = NeRF(**SMALL)
    weights = port.prepare_fused_nerf(model, torch.bfloat16)   # on the CPU
    pos, views = _inputs(8, cuda)
    with pytest.raises(ValueError, match="weights is on cpu"):
        port.fused_nerf_apply(weights, pos, views)


@pytest.mark.cuda
def test_fused_frame_matches_plain_frame(cuda):
    from fourier_feature_nets_torch.cameras import Resolution
    from fourier_feature_nets_torch.utils import orbit
    model = NeRF(**SMALL, generator=torch.Generator().manual_seed(3)).to(cuda)
    cameras = orbit(np.array([0, 1, 0]), np.array([0, 0, 1]), 2, 40.0,
                    Resolution(32, 32), 3.0)
    sampler = RaySampler(np.diag([2.0, 2.0, 2.0, 1.0]), cameras, 16, cuda)
    fused = Raycaster(model, compute_dtype=torch.bfloat16)
    assert fused.fused
    plain = Raycaster(model, compute_dtype=torch.bfloat16, fused=False)
    a = fused.render_frame(sampler, 1).astype(int)
    b = plain.render_frame(sampler, 1).astype(int)
    assert np.abs(a - b).max() <= 1
