"""K5, the clipped Adam kernel, against its twin (torch's capturable Adam
behind ``clip_grad_value_`` and ``clip_grad_norm_``) on a CUDA card.

Every test here needs a card and skips without one (the kernel has no
CPU mode). The file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_clipped_adam_cuda.py

Tolerances (``kernels/clipped_adam.py``'s ``K5_ULPS`` and ``K5_FLOOR``;
``csrc/clipped_adam.cu`` gives the readings and reasons): without the
norm clip every gradient, moment, parameter and step equals torch's bit
for bit (K5 follows torch's float order); with it, after 20 steps every
gradient, moment and parameter lies within ``K5_ULPS`` ulps of torch's, an ulp taken of the larger of the two values' magnitudes and of
``K5_FLOOR`` times the largest magnitude of torch's tensor; the steps are
equal. The 20-step test also prints each value's distance in its own
ulps.
"""

import numpy as np
import pytest
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from fourier_feature_nets_torch.kernels import clipped_adam as k5
from fourier_feature_nets_torch.models import flagship_nerf
from fourier_feature_nets_torch.models.hash_grid import instant_ngp
from fourier_feature_nets_torch.utils.optim import ClippedAdam, exponential_lr

STEPS = 20
CLIPS = (0.1, 0.1)          # (clip_value, clip_norm)
ULPS = k5.K5_ULPS
ulp_distance = k5.ulp_distance


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _model(name, device):
    generator = torch.Generator().manual_seed(5)
    model = (flagship_nerf(generator) if name == "nerf-8x256"
             else instant_ngp(generator))
    return [p.detach().to(device) for p in model.parameters()]


class _Pair:
    """The kernel's optimizer and the twin's, from the same values."""

    def __init__(self, values, weight_decay, clips, capturable=True):
        self.kernel = [torch.nn.Parameter(v.clone()) for v in values]
        self.twin = [torch.nn.Parameter(v.clone()) for v in values]
        self.clips = clips
        self.optimizer = ClippedAdam(self.kernel, 1e-2, weight_decay,
                                     clip_value=clips[0], clip_norm=clips[1],
                                     capturable=capturable)
        self.lr = torch.tensor(1e-2, device=values[0].device)
        self.reference = torch.optim.Adam(self.twin, lr=self.lr,
                                          weight_decay=weight_decay,
                                          capturable=True)

    def step(self, grads, lr):
        for p, q, g in zip(self.kernel, self.twin, grads):
            p.grad = None if g is None else g.clone()
            q.grad = None if g is None else g.clone()
        self.optimizer.step(lr)
        twin = [q for q in self.twin if q.grad is not None]
        if self.clips[0] is not None:
            torch.nn.utils.clip_grad_value_(twin, self.clips[0])
        if self.clips[1] is not None:
            torch.nn.utils.clip_grad_norm_(twin, self.clips[1])
        if isinstance(lr, torch.Tensor):
            self.lr.copy_(lr)
        else:
            self.lr.fill_(lr)
        self.reference.step()

    def distances(self, floor=k5.K5_FLOOR):
        """{name: largest ulp distance} over every tensor compared."""
        worst = {"grad": 0.0, "param": 0.0, "exp_avg": 0.0,
                 "exp_avg_sq": 0.0}
        for p, q in zip(self.kernel, self.twin):
            assert (p.grad is None) == (q.grad is None)
            if p.grad is not None:
                worst["grad"] = max(worst["grad"],
                                    ulp_distance(p.grad, q.grad, floor))
            worst["param"] = max(worst["param"], ulp_distance(p, q, floor))
            ours = self.optimizer.optimizer.state.get(p, {})
            theirs = self.reference.state.get(q, {})
            assert ours.keys() == theirs.keys()
            if not theirs:
                continue
            assert float(ours["step"]) == float(theirs["step"])
            for key in ("exp_avg", "exp_avg_sq"):
                worst[key] = max(worst[key],
                                 ulp_distance(ours[key], theirs[key], floor))
        return worst

    def equal(self) -> bool:
        """Every gradient, parameter, moment and step equals the twin's
        bit for bit."""
        pairs = []
        for p, q in zip(self.kernel, self.twin):
            assert (p.grad is None) == (q.grad is None)
            if p.grad is not None:
                pairs.append((p.grad, q.grad))
            pairs.append((p.detach(), q.detach()))
            ours = self.optimizer.optimizer.state.get(p, {})
            theirs = self.reference.state.get(q, {})
            assert ours.keys() == theirs.keys()
            pairs += [(ours[key], theirs[key]) for key in theirs]
        return all(torch.equal(a, b) for a, b in pairs)


def _grads(values, step, skip=None):
    generator = torch.Generator(values[0].device).manual_seed(1000 + step)
    grads = [torch.randn(v.shape, device=v.device, generator=generator)
             * 0.05 for v in values]
    if skip is not None:
        grads[skip] = None
    return grads


@pytest.mark.cuda
@pytest.mark.parametrize("weight_decay", [0.0, 1e-3], ids=["wd0", "wd1e-3"])
@pytest.mark.parametrize("clip", [CLIPS, (None, None), (0.1, None)],
                         ids=["clip", "noclip", "value"])
@pytest.mark.parametrize("name", ["nerf-8x256", "instant-ngp"])
def test_twenty_steps_match_torch(cuda, name, clip, weight_decay):
    """20 steps at a decaying rate, one parameter's gradient None on odd
    steps, two launches a step: with the norm clip every gradient,
    moment and parameter within ULPS ulps of torch's and the steps
    equal; without it (no clip, or the value clip alone) all of them
    equal to torch's bit for bit after every step."""
    values = _model(name, cuda)
    pair = _Pair(values, weight_decay, clip)
    before = k5.clipped_adam.launches
    worst, own = {}, {}
    for step in range(STEPS):
        pair.step(_grads(values, step, skip=1 if step % 2 else None),
                  exponential_lr(1e-2, torch.tensor(step, device=cuda), 0.1,
                                 250_000))
        for key, value in pair.distances().items():
            worst[key] = max(worst.get(key, 0.0), value)
        for key, value in pair.distances(floor=0.0).items():
            own[key] = max(own.get(key, 0.0), value)
        if clip[1] is None:
            assert pair.equal(), f"step {step}: {own}"
    torch.cuda.synchronize()
    print(f"{name} clip={clip} wd={weight_decay}: worst ulps {worst}; in "
          f"ulps of each value {own}")
    assert k5.clipped_adam.launches - before == 2 * STEPS
    assert max(worst.values()) <= ULPS, worst


@pytest.mark.cuda
def test_more_tensors_than_a_launch_holds(cuda):
    """40 tensors take two norm launches, then two update launches, and
    match torch as one list does."""
    generator = torch.Generator(cuda).manual_seed(2)
    values = [torch.randn(int(n), device=cuda, generator=generator)
              for n in np.random.default_rng(2).integers(1, 5000, 40)]
    pair = _Pair(values, 1e-3, CLIPS)
    before = k5.clipped_adam.launches
    for step in range(5):
        pair.step(_grads(values, step), 1e-2)
    assert k5.clipped_adam.launches - before == 5 * 4
    assert max(pair.distances().values()) <= ULPS


def _state(optimizer):
    return [t.clone() for t in (*optimizer.params,
                                *[p.grad for p in optimizer.params],
                                *optimizer.state_tensors())]


@pytest.mark.cuda
def test_two_launches_and_a_graph_replay_agree_bit_for_bit(cuda):
    """The same step from the same state, launched twice and replayed
    from a CUDA graph, writes the same bits."""
    values = _model("instant-ngp", cuda)
    pair = _Pair(values, 1e-3, CLIPS)
    pair.step(_grads(values, 0), 1e-2)
    optimizer = pair.optimizer
    grads = _grads(values, 1)
    for p, g in zip(optimizer.params, grads):
        p.grad = g.clone()
    start = _state(optimizer)
    lr = torch.tensor(5e-3, device=cuda)

    def restore():
        with torch.no_grad():
            for tensor, value in zip((*optimizer.params,
                                      *[p.grad for p in optimizer.params],
                                      *optimizer.state_tensors()), start):
                tensor.copy_(value)

    results = []
    for _ in range(2):
        restore()
        optimizer.step(lr)
        results.append(_state(optimizer))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        restore()
        optimizer.step(lr)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = k5.clipped_adam.launches
    with torch.cuda.graph(graph):
        optimizer.step(lr)
    assert k5.clipped_adam.launches - before == 2
    restore()
    graph.replay()
    torch.cuda.synchronize()
    results.append(_state(optimizer))
    for other in results[1:]:
        for a, b in zip(results[0], other):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_post_hook_sees_the_clipped_gradient(cuda):
    """A global post hook fires once a step and reads the gradient
    clipped by value and norm, as torch's calls leave it."""
    values = _model("nerf-8x256", cuda)
    pair = _Pair(values, 0.0, CLIPS)
    seen = []

    def hook(optimizer, args, kwargs):
        if optimizer is pair.optimizer.optimizer:
            seen.append([p.grad.clone() for p in pair.kernel])

    handle = register_optimizer_step_post_hook(hook)
    try:
        for step in range(3):
            grads = _grads(values, step)
            pair.step(grads, 1e-2)
            assert len(seen) == step + 1
            for ours, q, raw in zip(seen[-1], pair.twin, grads):
                assert ulp_distance(ours, q.grad) <= ULPS
            assert not all(torch.equal(ours, raw)
                           for ours, raw in zip(seen[-1], grads))
    finally:
        handle.remove()


@pytest.mark.cuda
def test_a_non_capturable_optimizer_takes_the_kernel(cuda):
    """A float learning rate: the kernel reads it from its argument; the
    steps live on the device."""
    values = _model("nerf-8x256", cuda)
    pair = _Pair(values, 1e-3, CLIPS, capturable=False)
    before = k5.clipped_adam.launches
    for step in range(3):
        pair.step(_grads(values, step), 1e-2)
    assert k5.clipped_adam.launches - before == 6
    state = pair.optimizer.optimizer.state[pair.kernel[0]]
    assert state["step"].device.type == "cuda"
    assert max(pair.distances().values()) <= ULPS


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float64", "bfloat16", "transposed",
                                  "sparse"])
def test_unsupported_tensors_raise(cuda, kind):
    if kind == "transposed":
        param = torch.nn.Parameter(torch.randn(8, 4, device=cuda).t())
    else:
        dtype = {"float64": torch.float64,
                 "bfloat16": torch.bfloat16}.get(kind, torch.float32)
        param = torch.nn.Parameter(torch.randn(8, 4, device=cuda,
                                               dtype=dtype))
    optimizer = ClippedAdam([param], 1e-2)
    if kind == "sparse":
        param.grad = torch.randn(8, 4, device=cuda).to_sparse()
    else:
        param.grad = torch.randn_like(param)
    before = k5.clipped_adam.launches
    with pytest.raises(ValueError, match="clipped Adam"):
        optimizer.step(1e-2)
    assert k5.clipped_adam.launches == before
