"""``ClippedAdam`` on the CPU, where it runs torch's own calls (K5's plain
twin), and K5's host side (``kernels/clipped_adam.py``): the launch
tables, the partial sums, the bound and the ulp measure. The kernel
itself runs on a card only (``tests/test_torch_clipped_adam_cuda.py``)."""

import numpy as np
import pytest
import torch
from torch.optim.optimizer import (
    register_optimizer_step_post_hook,
    register_optimizer_step_pre_hook,
)

from fourier_feature_nets_torch.kernels import clipped_adam as k5
from fourier_feature_nets_torch.utils.optim import ClippedAdam, _KernelAdam


def _params(seed=0, shapes=((5, 4), (7,), (3, 2))):
    rng = np.random.default_rng(seed)
    return [torch.nn.Parameter(torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))) for shape in shapes]


def _set_grads(params, seed, scale=0.3):
    rng = np.random.default_rng(100 + seed)
    for p in params:
        p.grad = torch.from_numpy(
            (rng.normal(size=tuple(p.shape)) * scale).astype(np.float32))


def test_cpu_route_is_torchs_adam():
    optimizer = ClippedAdam(_params(), 1e-2)
    assert not optimizer.kernel
    assert type(optimizer.optimizer) is torch.optim.Adam


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "noclip"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-3], ids=["wd0", "wd1e-3"])
def test_cpu_step_is_the_torch_calls_bit_for_bit(clip, weight_decay):
    """Three steps equal clip_grad_value_, clip_grad_norm_ and
    torch.optim.Adam run by hand, one parameter's gradient None on the
    second step."""
    ours, theirs = _params(1), _params(1)
    clips = (0.1, 0.1) if clip else (None, None)
    optimizer = ClippedAdam(ours, 1e-2, weight_decay, clip_value=clips[0],
                            clip_norm=clips[1])
    adam = torch.optim.Adam(theirs, lr=1e-2, weight_decay=weight_decay)
    for step in range(3):
        for params in (ours, theirs):
            _set_grads(params, step)
            if step == 1:
                params[1].grad = None
        optimizer.step(1e-2 * 0.9 ** step)
        live = [p for p in theirs if p.grad is not None]
        if clip:
            torch.nn.utils.clip_grad_value_(live, 0.1)
            torch.nn.utils.clip_grad_norm_(live, 0.1)
        for group in adam.param_groups:
            group["lr"] = 1e-2 * 0.9 ** step
        adam.step()
        for p, q in zip(ours, theirs):
            assert torch.equal(p, q)
            assert (p.grad is None) == (q.grad is None)
            if p.grad is not None:
                assert torch.equal(p.grad, q.grad)
    assert float(optimizer.optimizer.state[ours[1]]["step"]) == 2.0
    assert float(optimizer.optimizer.state[ours[0]]["step"]) == 3.0


def test_cpu_state_keys_devices_and_order():
    params = _params()
    optimizer = ClippedAdam(params, 1e-2)
    tensors = optimizer.state_tensors()
    assert len(tensors) == 3 * len(params)
    for i, p in enumerate(params):
        state = optimizer.optimizer.state[p]
        assert list(state) == ["step", "exp_avg", "exp_avg_sq"]
        assert tensors[3 * i] is state["step"]
        assert tensors[3 * i + 1] is state["exp_avg"]
        assert tensors[3 * i + 2] is state["exp_avg_sq"]
        assert state["step"].dtype == torch.float32
        assert state["step"].shape == () and state["step"].device.type == "cpu"
        assert float(state["step"]) == 0.0
        assert not state["exp_avg"].any() and not state["exp_avg_sq"].any()
    storage = [t.data_ptr() for t in tensors]
    _set_grads(params, 0)
    optimizer.step(1e-2)
    assert [t.data_ptr() for t in optimizer.state_tensors()] == storage
    assert all(float(optimizer.optimizer.state[p]["step"]) == 1.0
               for p in params)


def test_cpu_jax_state_round_trip():
    """jax_state then load_jax_state into a fresh optimizer restores the
    step and both moments in place, and the two then step alike."""
    params = _params(2, ((4, 3), (6,)))
    named = {"layer/weight": params[0], "layer/bias": params[1]}
    optimizer = ClippedAdam(params, 1e-2, 1e-3)
    for step in range(2):
        _set_grads(params, step)
        optimizer.step(1e-2)
    step, mu, nu = optimizer.jax_state(named)
    assert step == 2
    assert mu["layer/weight"].shape == (3, 4)   # JAX's (in, out)
    copies = [torch.nn.Parameter(p.detach().clone()) for p in params]
    fresh = ClippedAdam(copies, 1e-2, 1e-3)
    storage = [t.data_ptr() for t in fresh.state_tensors()]
    fresh.load_jax_state({"layer/weight": copies[0],
                          "layer/bias": copies[1]}, step, mu, nu)
    assert [t.data_ptr() for t in fresh.state_tensors()] == storage
    for a, b in zip(fresh.state_tensors(), optimizer.state_tensors()):
        assert torch.equal(a, b)
    for opt, ps in ((optimizer, params), (fresh, copies)):
        _set_grads(ps, 7)
        opt.step(5e-3)
    for p, q in zip(params, copies):
        assert torch.equal(p, q)


def test_cpu_post_hook_sees_the_clipped_gradient():
    params = _params(3)
    optimizer = ClippedAdam(params, 1e-2)
    seen = []

    def hook(opt, args, kwargs):
        if opt is optimizer.optimizer:
            seen.append([p.grad.clone() for p in params])

    handle = register_optimizer_step_post_hook(hook)
    try:
        for step in range(2):
            _set_grads(params, step, scale=1.0)
            raw = [p.grad.clone() for p in params]
            optimizer.step(1e-2)
            assert len(seen) == step + 1
            grads = seen[-1]
            assert max(float(g.abs().max()) for g in grads) <= 0.1
            norm = float(torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads])))
            assert norm <= 0.1 * (1 + 1e-5)
            assert not all(torch.equal(g, r) for g, r in zip(grads, raw))
    finally:
        handle.remove()


def test_kernel_optimizer_step_is_torchs_hooked_step():
    """The CUDA route's optimizer is an Adam whose step torch wraps: a
    global pre hook fires before it; with no gradient it does nothing, and
    CPU tensors reach the kernel's wrapper, which raises."""
    params = _params(4)
    optimizer = _KernelAdam(params, 1e-2, 0.0, False, 0.1, 0.1)
    assert isinstance(optimizer, torch.optim.Adam)
    fired = []
    handle = register_optimizer_step_pre_hook(
        lambda opt, args, kwargs: fired.append(opt))
    try:
        optimizer.step()
        assert fired == [optimizer] and not optimizer.state
        _set_grads(params, 0)
        with pytest.raises(ValueError, match="CUDA tensors"):
            optimizer.step()
        assert fired == [optimizer, optimizer]
    finally:
        handle.remove()


def test_wrapper_raises_for_cpu_tensors():
    p = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k5.clipped_adam([p], [p], [p], [p], [torch.zeros(())], lr=1e-2,
                        beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
                        clip_value=0.1, clip_norm=0.1)
    before = k5.clipped_adam.launches
    k5.clipped_adam([], [], [], [], [], lr=1e-2, beta1=0.9, beta2=0.999,
                    eps=1e-8, weight_decay=0.0, clip_value=None,
                    clip_norm=None)
    assert k5.clipped_adam.launches == before


def _lists(count, sizes=None):
    sizes = sizes or [3 + i for i in range(count)]
    params = [torch.zeros(n) for n in sizes]
    return (params, [torch.zeros(n) for n in sizes],
            [torch.zeros(n) for n in sizes], [torch.zeros(n) for n in sizes],
            [torch.zeros(()) for _ in sizes])


@pytest.mark.parametrize("count", [1, 6, 24, 32, 33, 70])
def test_tensor_rows_split_at_max_tensors(count):
    lists = _lists(count)
    tables = k5.tensor_rows(*lists)
    assert [len(t) for t in tables] == \
        [min(k5.MAX_TENSORS, count - i)
         for i in range(0, count, k5.MAX_TENSORS)]
    rows = np.concatenate(tables)
    assert all(t.dtype == np.int64 and t.flags.c_contiguous for t in tables)
    for row, *tensors in zip(rows, *lists):
        assert list(row[:5]) == [t.data_ptr() for t in tensors]
        assert row[5] == tensors[0].numel()


@pytest.mark.parametrize("kind", ["float64", "bfloat16", "transposed",
                                  "shape", "step", "sparse"])
def test_tensor_rows_refuse_what_the_kernel_cannot_take(kind):
    params, grads, ms, vs, steps = _lists(3, [12, 12, 12])
    if kind in ("float64", "bfloat16"):
        grads[1] = grads[1].to(getattr(torch, kind))
    elif kind == "transposed":
        params[2] = torch.zeros(3, 4).t()
        grads[2], ms[2], vs[2] = (torch.zeros(4, 3) for _ in range(3))
    elif kind == "shape":
        vs[0] = torch.zeros(11)
    elif kind == "step":
        steps[0] = torch.zeros(1)
    else:
        grads[0] = grads[0].to_sparse()
    with pytest.raises(ValueError, match="contiguous float32"):
        k5.tensor_rows(params, grads, ms, vs, steps)


@pytest.mark.parametrize("sizes, partials", [
    ([1], 1), ([0], 1), ([2048], 1), ([2049], 2), ([2048 * 600], 512),
    ([100] * 20, 20), ([12_196_240, 2048, 1024, 2048, 4096, 192], 512)])
def test_partial_count(sizes, partials):
    table = np.zeros((len(sizes), 6), np.int64)
    table[:, 5] = sizes
    assert k5.partial_count(table) == partials


def test_compulsory_bytes_give_the_instant_ngp_bound():
    """0.44 GB, 0.131 ms at 3.35 TB/s for Instant-NGP's 12,205,648."""
    total = k5.compulsory_bytes(12_205_648)
    assert total == 12_205_648 * 36
    assert total / 3.35e12 * 1e3 == pytest.approx(0.1312, abs=1e-4)


def test_ulp_distance():
    one = torch.tensor([1.0, -2.0, 0.0])
    assert k5.ulp_distance(one, one) == 0.0
    up = torch.nextafter(one, torch.full_like(one, 10.0))
    assert k5.ulp_distance(up, one, floor=0.0) == pytest.approx(1.0)
    # the floor: 0 against 2^-30 is 2^-30 / ulp(floor * 2); the default
    # floor, 1, measures in ulps of the tensor's largest magnitude
    small = torch.tensor([2.0 ** -30, 2.0])
    zero = torch.tensor([0.0, 2.0])
    assert k5.ulp_distance(small, zero, floor=2.0 ** -12) == pytest.approx(
        2.0 ** -30 / 2.0 ** (-11 - 23))
    assert k5.ulp_distance(small, zero) == pytest.approx(
        2.0 ** -30 / 2.0 ** (1 - 23))
    assert k5.ulp_distance(torch.zeros(0), torch.zeros(0)) == 0.0
