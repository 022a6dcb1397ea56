"""The kernel wrappers' one launch path (kernels/launch.py), with Python
stand-ins for the ctypes entry points, and the wrappers' CPU contract:
CPU tensors run the plain twins and never reach the launch path."""

import contextlib
import ctypes
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fourier_feature_nets_torch.kernels import fused_nerf, fused_nerf_ablation
from fourier_feature_nets_torch.kernels import fused_nerf_train
from fourier_feature_nets_torch.kernels import int8_probe, io_floor, launch
from fourier_feature_nets_torch.kernels.build import BuiltLibrary
from fourier_feature_nets_torch.models import NeRF

# the package exports the function of the same name
ray_module = importlib.import_module(
    "fourier_feature_nets_torch.kernels.fused_ray_render")

CUDA0 = torch.device("cuda", 0)


def _wrapper():
    def wrapper():
        pass
    wrapper.launches = 0
    return wrapper


@pytest.fixture
def current(monkeypatch):
    """Current device 0 and a fixed stream handle, as on a card."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(launch, "current_stream", lambda index: 4242)


@pytest.fixture
def library(monkeypatch):
    """A KernelLibrary whose build gives Python stand-ins for the ctypes
    entry point ``fake_entry`` and error function ``fake_error``; the
    entry records its arguments and returns ``code``."""
    def entry(*args):
        entry.calls.append(args)
        return entry.code

    def error(code):
        return {0: b"no error", 98: b"invalid device function"}[code]

    entry.calls, entry.code, builds = [], 0, []

    def build(source):
        builds.append(source)
        return BuiltLibrary(SimpleNamespace(fake_entry=entry,
                                            fake_error=error), None, 0.0, "")

    monkeypatch.setattr(launch, "build_library", build)
    fake = launch.KernelLibrary("fake.cu", "fake_error",
                                fake_entry=(launch.PTR, launch.INT))
    return SimpleNamespace(library=fake, entry=entry, error=error,
                           builds=builds)


def test_zero_return_counts_one_launch_and_passes_the_stream(current,
                                                             library):
    wrapper = _wrapper()
    library.library.launch(wrapper, "fake_entry", CUDA0, 1, 2)
    assert library.entry.calls == [(1, 2, 4242)]
    assert wrapper.launches == 1


def test_nonzero_return_raises_with_the_error_string_and_counts_none(
        current, library):
    library.entry.code = 98
    wrapper = _wrapper()
    with pytest.raises(RuntimeError, match=r"fake_entry kernel launch "
                       r"failed: invalid device function \(cudaError 98\)"):
        library.library.launch(wrapper, "fake_entry", CUDA0, 7, 8)
    assert wrapper.launches == 0


def test_another_device_is_entered_only_when_not_current(monkeypatch,
                                                         current, library):
    entered = []

    @contextlib.contextmanager
    def device(index):
        entered.append(index)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    wrapper = _wrapper()
    library.library.launch(wrapper, "fake_entry", CUDA0, 1, 2)
    assert entered == []
    devices = iter([0, 1])   # device 1 is current once the context is in
    monkeypatch.setattr(torch.cuda, "current_device", lambda: next(devices))
    streams = []
    monkeypatch.setattr(launch, "current_stream",
                        lambda index: streams.append(index) or 0)
    library.library.launch(wrapper, "fake_entry", torch.device("cuda", 1),
                           3, 4)
    assert entered == [1] and streams == [1]
    assert library.entry.calls[-1] == (3, 4, 0)
    assert wrapper.launches == 2


def test_library_types_each_entry_once(current, library):
    wrapper = _wrapper()
    for _ in range(3):
        library.library.launch(wrapper, "fake_entry", CUDA0, 11, 12)
    assert library.builds == ["fake.cu"]
    assert library.entry.argtypes == [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
    assert library.entry.restype is ctypes.c_int
    assert library.error.argtypes == [ctypes.c_int]
    assert library.error.restype is ctypes.c_char_p
    assert library.library.error_string(0) == "no error"
    assert library.library.load() is library.library.load()
    assert wrapper.launches == 3


def test_on_cuda_sorts_devices():
    assert launch.on_cuda(SimpleNamespace(device=CUDA0), "x")
    assert not launch.on_cuda(torch.zeros(1), "x")
    with pytest.raises(ValueError, match="no probe kernel for meta"):
        launch.on_cuda(torch.zeros(1, device="meta"), "probe")


def _small_pack():
    model = NeRF(num_layers=2, num_channels=32, max_log_scale_pos=3.0,
                 num_freq_pos=4, max_log_scale_view=1.0, num_freq_view=2,
                 skips=[], include_inputs=True,
                 generator=torch.Generator().manual_seed(0))
    return fused_nerf.prepare_fused_nerf(model, torch.float32)


def _cpu_calls():
    """Every kernel wrapper, called on CPU tensors."""
    rng = np.random.default_rng(0)
    pack = _small_pack()
    pos = torch.from_numpy(rng.uniform(-1, 1, (8, 3)).astype(np.float32))
    views = torch.nn.functional.normalize(pos + 0.1, dim=-1)
    rays, t = pos.reshape(2, 4, 3), torch.linspace(1, 2, 4).repeat(2, 1)
    w = torch.from_numpy(rng.integers(-127, 128, (16, 16)).astype(np.int8))
    x = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    return {
        "fused_nerf": lambda: fused_nerf.fused_nerf_apply(pack, pos, views),
        "fused_nerf_train": lambda: fused_nerf_train.fused_nerf_backward(
            pack, pos, views, torch.ones(8, 4)),
        "fused_ray_render": lambda: ray_module.fused_ray_render(
            pack, rays, views[:2], t),
        "exclusive_cumprod_scan": lambda: ray_module.exclusive_cumprod_scan(
            torch.rand(3, 5) + 0.5),
        "fused_nerf_ablation": lambda: fused_nerf_ablation.fused_nerf_ablation(
            pack, pos, views, "no-view"),
        "int8_matmul": lambda: int8_probe.int8_matmul(w, w),
        "quantized_matmul": lambda: int8_probe.quantized_matmul(x, w),
        "layer_stack": lambda: int8_probe.layer_stack(w[:, :8].clone(),
                                                      w[None]),
        "io_narrow": lambda: io_floor.io_narrow(pos, views, 4),
        "io_wide": lambda: io_floor.io_wide(torch.zeros(4, 128)),
        "packed8": lambda: io_floor.packed8(torch.zeros(4, 8)),
    }


@pytest.mark.parametrize("name", sorted(_cpu_calls()))
def test_cpu_tensors_never_reach_the_launch_path(monkeypatch, name):
    reached = []

    def refuse(*args, **kwargs):
        reached.append(args)
        raise AssertionError("a CPU call reached the launch path")

    monkeypatch.setattr(launch.KernelLibrary, "launch", refuse)
    monkeypatch.setattr(launch.KernelLibrary, "load", refuse)
    out = _cpu_calls()[name]()
    assert reached == []
    assert all(torch.isfinite(o).all() for o in
               (out if isinstance(out, tuple) else (out,)))


def test_every_wrapper_module_launches_through_one_library():
    """The wrappers hold a KernelLibrary each and keep no copy of the
    launch steps (device context, stream lookup, error text)."""
    import inspect
    for module in (fused_nerf, fused_nerf_train, ray_module,
                   fused_nerf_ablation, int8_probe, io_floor):
        assert isinstance(module._LIB, launch.KernelLibrary)
        source = inspect.getsource(module)
        for copy in ("torch.cuda.device(", "current_stream(", "cuda_stream",
                     "error_string(", "launches += 1"):
            assert copy not in source, (module.__name__, copy)
