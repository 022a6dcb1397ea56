"""The port's data parallelism (``fourier_feature_nets_torch/parallel``)
against the JAX package's mesh, on the CPU.

Each rank is a subprocess (``tests/torch_parallel_worker.py``) in a gloo
process group on 127.0.0.1, with one thread; the JAX side runs here on
as many of the suite's 8 virtual CPU devices. The same scene, weights
and permutation go to both. Held:

* the data-parallel step, plain and fused (the kernels' twins), and
  three steps a call with ``refresh()``: the losses within rtol 1e-5 of
  JAX's ``make_shard_map_train_step`` on its mesh, the weights after the
  steps within rtol 2e-3 / atol 2e-4, and every rank's weights equal;
* an occupancy-guided, stratified, fused ``fit`` over the mesh: within
  rtol 1e-4 (PSNR) and 1e-4 (weights) of the same ``fit`` in one
  process, and within 0.5 dB val PSNR of JAX's ``fit(mesh=...)``, whose
  epoch permutation and jitter draw other bits;
* the same fit without jitter and with the epoch order handed to both:
  every report's losses within rtol 1e-5 of JAX's ``fit(mesh=...)``
  and the weights within rtol 2e-3 / atol 2e-4;
* the culled and early-terminated frames under the mesh, in ragged
  chunks: within 1 of JAX's ``render_frame(mesh=...)``; the render
  server's frames with follower ranks;
* a two-process ``train_nerf --data-parallel`` launched as ``torchrun``
  would (the counterpart of ``tests/test_multihost.py``).

Each run of ranks has a join timeout that fails its test.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_feature_nets_tpu as ffn
from fourier_feature_nets_torch.cli import train_nerf as port_train_nerf
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import load_model as port_load
from fourier_feature_nets_torch.models import params_from_jax, params_to_jax
from fourier_feature_nets_torch.parallel import (
    Mesh,
    initialize_distributed,
    make_mesh,
    make_shard_map_train_step as port_dp_step,
    shard_rays,
)
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.parallel import (
    make_mesh as jax_make_mesh,
    make_shard_map_train_step as jax_dp_step,
    replicate,
)
from fourier_feature_nets_tpu.render import Raycaster
from fourier_feature_nets_tpu.render.occupancy_sampler import (
    OccupancyGridSampler,
)
from fourier_feature_nets_tpu.utils import adam_init
from fourier_feature_nets_tpu.utils.camera_paths import orbit

WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(num_layers=2, num_channels=32, max_log_scale_pos=3.0,
              num_freq_pos=4, max_log_scale_view=1.0, num_freq_view=2,
              skips=[1], include_inputs=True)
BATCH = 64
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
FIT = dict(batch_size=BATCH, learning_rate=1e-3, num_steps=12, crop_steps=0,
           report_interval=6, decay_rate=0.1, decay_steps=250000, seed=3,
           steps_per_call=2, occupancy_interval=4, occupancy_start=4,
           occupancy_samples=8)
JOIN_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK"):
        env.pop(name, None)
    return env


def _join(procs, timeout=JOIN_TIMEOUT):
    """Waits for every process; kills them all and fails the test when
    one outlives ``timeout`` or exits non-zero."""
    outputs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
                other.communicate()
            pytest.fail(f"a rank outlived the {timeout} s join timeout")
        outputs.append(out)
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outputs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    scene = str(root / "scene.npz")
    generate_synthetic_dataset(scene, resolution=24, split_counts=(3, 1, 1),
                               volume_side=16, num_samples=64)
    model = NeRF(**CONFIG)
    params = model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    np.savez(root / "params.npz", **flat)
    pool = ffn.ImageDataset.load(scene, "train", 16).index_pool()
    perm = np.random.default_rng(1).permutation(pool).astype(np.int64)
    np.save(root / "perm.npy", perm)
    order = np.random.default_rng(2).permutation(len(pool)).astype(np.int64)
    np.save(root / "order.npy", order)
    c = (np.arange(16) + 0.5) / 16 * 2 - 1
    zz, yy, xx = np.meshgrid(c, c, c, indexing="ij")
    grid = (np.sqrt((xx - 0.3) ** 2 + yy ** 2 + zz ** 2) < 0.45).astype(
        np.float32)
    np.save(root / "grid.npy", grid)
    return dict(root=root, scene=scene, model=model, params=params,
                flat=flat, perm=perm, order=order, grid=grid)


_RUNS = {}


def _ranks(setup, world):
    """Every job of the worker on ``world`` gloo ranks, run once per
    module: a list of each rank's results."""
    if world not in _RUNS:
        out = setup["root"] / f"world{world}"
        out.mkdir()
        spec = dict(scene=setup["scene"],
                    params=str(setup["root"] / "params.npz"),
                    perm=str(setup["root"] / "perm.npy"),
                    grid=str(setup["root"] / "grid.npy"),
                    order=str(setup["root"] / "order.npy"), config=CONFIG,
                    fit=FIT, out=str(out),
                    jobs=["steps", "multi", "fit", "fit_shared", "frame",
                          "server"])
        with open(out / "spec.json", "w") as handle:
            json.dump(spec, handle)
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, WORKER, str(rank), str(world), str(port),
             str(out / "spec.json")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=_env())
            for rank in range(world)]
        _join(procs)
        _RUNS[world] = [dict(np.load(out / f"rank{rank}.npz"))
                        for rank in range(world)]
    return _RUNS[world]


def _params(results, prefix):
    return {k.split("/", 1)[1]: v for k, v in results.items()
            if k.startswith(prefix + "/")}


def _jax_mesh(world):
    return jax_make_mesh(jax.devices("cpu")[:world])


def _jax_steps(setup, world, fused, steps_per_call=1):
    mesh = _jax_mesh(world)
    data = ffn.ImageDataset.load(setup["scene"], "train", 16)
    step = jax_dp_step(Raycaster(setup["model"], fused_train=fused), data,
                       BATCH, 5e-4, 0.1,
                       250000, 0.0, mesh, fused=fused,
                       steps_per_call=steps_per_call)
    params = replicate(jax.tree.map(jnp.copy, setup["params"]), mesh)
    opt = replicate(adam_init(setup["params"]), mesh)
    return data, step, params, opt, jnp.asarray(setup["perm"], jnp.int32)


def _assert_weights(ours, ref, rtol=2e-3, atol=2e-4):
    ref = {k: np.asarray(v) for k, v in _flatten(ref).items()}
    assert sorted(ours) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(ours[name], ref[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def _assert_ranks_equal(ranks, prefix):
    first = _params(ranks[0], prefix)
    for other in ranks[1:]:
        for name, value in _params(other, prefix).items():
            assert np.max(np.abs(value - first[name])) == 0, (prefix, name)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_dp_steps_match_jax_mesh(setup, world, fused):
    ranks = _ranks(setup, world)
    _, step, params, opt, perm = _jax_steps(setup, world, fused)
    losses = []
    for k in range(3):
        params, opt, loss = step(params, opt, perm,
                                 jnp.asarray(k * BATCH, jnp.int32),
                                 jnp.asarray(k, jnp.int32),
                                 jax.random.PRNGKey(0))
        losses.append(float(loss))
    tag = f"steps{int(fused)}"
    for results in ranks:
        np.testing.assert_allclose(results[tag + "_loss"], losses, rtol=1e-5)
    _assert_weights(_params(ranks[0], tag), params)
    _assert_ranks_equal(ranks, tag)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_steps_per_call_and_refresh_match_jax(setup, world):
    """Three steps a call, then a table the step never saw (the colors
    set to 1) and ``refresh()``: JAX's step swaps its jit arguments, the
    port's reads the new tensor; both losses and the weights agree."""
    ranks = _ranks(setup, world)
    data, step, params, opt, perm = _jax_steps(setup, world, False, 3)
    zero = jnp.asarray(0, jnp.int32)
    params, opt, first = step(params, opt, perm, zero, zero,
                              jax.random.PRNGKey(0))
    original = data.colors
    try:
        data.colors = jnp.ones_like(original)
        step.refresh()
        params, opt, second = step(params, opt, perm, zero,
                                   jnp.asarray(3, jnp.int32),
                                   jax.random.PRNGKey(0))
    finally:
        data.colors = original
    assert float(first) != pytest.approx(float(second), rel=1e-3)
    for results in ranks:
        np.testing.assert_allclose(results["multi_loss"],
                                   [float(first), float(second)], rtol=1e-5)
    _assert_weights(_params(ranks[0], "multi"), params)
    _assert_ranks_equal(ranks, "multi")


@pytest.fixture(scope="module")
def single_fit(setup):
    """The same fit as the worker's, in this process without a mesh."""
    model = params_from_jax(TorchNeRF(**CONFIG), setup["flat"])
    train = TorchDataset.load(setup["scene"], "train", 16, stratified=True)
    val = TorchDataset.load(setup["scene"], "val", 16)
    log = TorchRaycaster(model, fused_train=True).fit(train, val, **FIT)
    return log, params_to_jax(model)


@pytest.fixture(scope="module")
def jax_mesh_fit(setup):
    train = ffn.ImageDataset.load(setup["scene"], "train", 16,
                                  stratified=True)
    val = ffn.ImageDataset.load(setup["scene"], "val", 16)
    _, log = Raycaster(setup["model"], fused_train=False).fit(
        setup["params"], train, val, mesh=_jax_mesh(2), **FIT)
    return log


@pytest.mark.parametrize("world", [2, 4])
def test_dp_fit_matches_single_process_and_jax(setup, single_fit,
                                               jax_mesh_fit, world):
    ranks = _ranks(setup, world)
    log, weights = single_fit
    single = np.array([[e.step, e.train_psnr, e.val_psnr] for e in log])
    for results in ranks:
        assert bool(results["fit_restored"])
        np.testing.assert_allclose(results["fit_psnr"], single, rtol=1e-4)
    ours = _params(ranks[0], "fit")
    for name, value in weights.items():
        np.testing.assert_allclose(ours[name], value, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    _assert_ranks_equal(ranks, "fit")
    assert [e.step for e in jax_mesh_fit] == list(single[:, 0])
    assert single[-1, 2] == pytest.approx(jax_mesh_fit[-1].val_psnr, abs=0.5)


def _jax_shared_fit(setup, world):
    """JAX's occupancy-guided ``fit(mesh=...)`` without jitter, its epoch
    permutation the worker's shared order: (log, params)."""
    train = ffn.ImageDataset.load(setup["scene"], "train", 16)
    val = ffn.ImageDataset.load(setup["scene"], "val", 16)
    order = jnp.asarray(setup["order"])
    permutation = jax.random.permutation

    def shared(key, pool):
        assert len(pool) == len(order)
        return jnp.asarray(pool)[order]

    jax.random.permutation = shared
    try:
        params, log = Raycaster(setup["model"], fused_train=False).fit(
            setup["params"], train, val, mesh=_jax_mesh(world), **FIT)
    finally:
        jax.random.permutation = permutation
    return log, params


@pytest.mark.parametrize("world", [2, 4])
def test_dp_fit_without_jitter_matches_jax_mesh_fit(setup, world):
    """With the epoch order shared and no jitter (whose bits differ:
    threefry in JAX, a hash in the port), the fused fit over the mesh
    tracks JAX's plain ``fit(mesh=...)`` through the occupancy refresh:
    every report's losses (10^(-PSNR/10)) within rtol 1e-5, the weights
    within the step tests' rtol 2e-3 / atol 2e-4."""
    ranks = _ranks(setup, world)
    log, params = _jax_shared_fit(setup, world)
    ref = np.array([[e.step, e.train_psnr, e.val_psnr] for e in log])
    for results in ranks:
        ours = results["fit_shared_psnr"]
        np.testing.assert_array_equal(ours[:, 0], ref[:, 0])
        np.testing.assert_allclose(10 ** (-ours[:, 1:] / 10),
                                   10 ** (-ref[:, 1:] / 10), rtol=1e-5)
    _assert_weights(_params(ranks[0], "fit_shared"), params)
    _assert_ranks_equal(ranks, "fit_shared")


def _jax_frames(setup, world):
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]), 3,
                    40.0, Resolution(20, 20), 3.0)
    sampler = OccupancyGridSampler(
        None, cameras, 12, num_probes=16, empty_weight=0.1, bounds=BOUNDS,
        occupancy_grid=setup["grid"], grid_scale=1.0)
    caster = Raycaster(setup["model"])
    mesh = _jax_mesh(world)
    params = setup["params"]
    return {
        "frame": caster.render_frame(params, sampler, 0, chunk_size=50,
                                     mesh=mesh),
        "frame_early": caster.render_frame(params, sampler, 1, chunk_size=50,
                                           early_term=0.01, mesh=mesh),
        "served": caster.render_frame(params, sampler, 1, chunk_size=50),
        "served_pose": caster.render_frame_pose(params, sampler, cameras[2],
                                                chunk_size=50),
    }


@pytest.mark.parametrize("world", [2, 4])
def test_dp_frames_match_jax_mesh(setup, world):
    """Every rank returns the whole frame, within 1 of JAX's frame under
    its mesh; the server's rig and pose frames (rank 0, its followers
    joining) within 1 of JAX's frames."""
    ranks = _ranks(setup, world)
    ref = _jax_frames(setup, world)
    for name in ("frame", "frame_early"):
        assert (ref[name] == 0).all(-1).any() and ref[name].any()
        for results in ranks:
            diff = np.abs(results[name].astype(int) - ref[name].astype(int))
            assert diff.max() <= 1, (name, diff.max())
    for name in ("served", "served_pose"):
        diff = np.abs(ranks[0][name].astype(int) - ref[name].astype(int))
        assert diff.max() <= 1, (name, diff.max())
    assert [int(r["followed"]) for r in ranks[1:]] == [2] * (world - 1)


def test_indivisible_batch_raises_as_jax(setup):
    """A batch that does not divide over the mesh raises JAX's
    ValueError, before any collective."""
    data = TorchDataset.load(setup["scene"], "train", 16)
    model = params_from_jax(TorchNeRF(**CONFIG), setup["flat"])
    with pytest.raises(ValueError) as ours:
        port_dp_step(TorchRaycaster(model), data, 66, 5e-4, 0.1, 250000, 0.0,
                     Mesh(None, 4, 1, "cpu"))
    with pytest.raises(ValueError) as ref:
        jax_dp_step(Raycaster(setup["model"]),
                    ffn.ImageDataset.load(setup["scene"], "train", 16), 66,
                    5e-4, 0.1, 250000, 0.0, _jax_mesh(4))
    assert str(ours.value) == str(ref.value)


def test_initialize_distributed_without_environment(monkeypatch):
    """Without an address or torchrun's variables it is a no-op that
    returns False, and the mesh is this process alone."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed(device="cpu") is False
    mesh = make_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.collective) == (1, 0, False)
    assert mesh.axis_names == ("data",)
    rays = torch.arange(12)
    assert torch.equal(shard_rays(rays, mesh), rays)
    assert torch.equal(shard_rays(rays, Mesh(None, 4, 2, "cpu")),
                       torch.arange(6, 9))
    with pytest.raises(ValueError, match="divide evenly"):
        shard_rays(torch.arange(10), Mesh(None, 4, 0, "cpu"))


def test_two_process_train_nerf_cli(setup, tmp_path):
    """``train_nerf --data-parallel`` on two ranks started with
    torchrun's variables: rank 0 alone writes the run's files, and its
    model equals the same run in one process."""
    small = ["--device", "cpu", "--num-layers", "2", "--num-channels", "32",
             "--num-samples", "8", "--batch-size", "64", "--image-interval",
             "0", "--crop-steps", "0", "--report-interval", "4",
             "--num-steps", "8", "--steps-per-call", "2"]
    out = tmp_path / "dp"
    port = _free_port()
    procs = []
    for rank in range(2):
        env = _env()
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fourier_feature_nets_torch.cli.train_nerf",
             setup["scene"], str(out), "--data-parallel", *small],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT))
    outputs = _join(procs)
    assert "train_nerf:" in outputs[0] and "train_nerf:" not in outputs[1]
    assert "psnr_train" not in outputs[1]
    assert port_train_nerf.main([setup["scene"], str(tmp_path / "one"),
                                 *small]) == 0
    ours = params_to_jax(port_load(str(out / "nerf.npz")))
    ref = params_to_jax(port_load(str(tmp_path / "one" / "nerf.npz")))
    for name, value in ref.items():
        np.testing.assert_allclose(ours[name], value, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert sorted(os.listdir(out)) == sorted(os.listdir(tmp_path / "one"))
