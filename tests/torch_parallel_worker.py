"""One rank of the port's data-parallel tests (``tests/test_torch_parallel.py``).

    python tests/torch_parallel_worker.py RANK WORLD PORT SPEC_JSON

Joins a gloo process group of WORLD ranks on 127.0.0.1:PORT, runs the
jobs the spec names on a mesh of those ranks and writes what they
return to ``<out>/rank<RANK>.npz``. It imports the port only, never
JAX: the parent test runs the JAX side.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from fourier_feature_nets_torch.cameras import Resolution
from fourier_feature_nets_torch.datasets import ImageDataset
from fourier_feature_nets_torch.models import NeRF, params_from_jax
from fourier_feature_nets_torch.models import params_to_jax
from fourier_feature_nets_torch.parallel import (
    initialize_distributed,
    make_mesh,
    make_shard_map_train_step,
)
from fourier_feature_nets_torch.render import OccupancyGridSampler
from fourier_feature_nets_torch.render import Raycaster
from fourier_feature_nets_torch.render.server import RenderServer, follow
from fourier_feature_nets_torch.utils import orbit

BATCH = 64
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)


def model_from(spec) -> NeRF:
    flat = dict(np.load(spec["params"]))
    return params_from_jax(NeRF(**spec["config"]), flat)


def save_params(results, prefix, model):
    for name, value in params_to_jax(model).items():
        results[f"{prefix}/{name}"] = value


def job_steps(spec, mesh, results):
    """Three single steps, plain and fused (the twins on the CPU)."""
    perm = torch.from_numpy(np.load(spec["perm"]))
    for fused in (False, True):
        model = model_from(spec)
        data = ImageDataset.load(spec["scene"], "train", 16)
        step = make_shard_map_train_step(Raycaster(model), data, BATCH, 5e-4,
                                         0.1, 250000, 0.0, mesh, fused=fused)
        losses = [float(step(perm, k * BATCH, k, 0)) for k in range(3)]
        results[f"steps{int(fused)}_loss"] = np.array(losses)
        save_params(results, f"steps{int(fused)}", model)


def job_multi(spec, mesh, results):
    """Three steps a call, then the dataset's colors swapped and
    ``refresh()``, then another call."""
    perm = torch.from_numpy(np.load(spec["perm"]))
    model = model_from(spec)
    data = ImageDataset.load(spec["scene"], "train", 16)
    step = make_shard_map_train_step(Raycaster(model), data, BATCH, 5e-4, 0.1,
                                     250000, 0.0, mesh, steps_per_call=3)
    first = float(step(perm, 0, 0, 0))
    data.colors = torch.ones_like(data.colors)
    step.refresh()
    second = float(step(perm, 0, 3, 0))
    results["multi_loss"] = np.array([first, second])
    save_params(results, "multi", model)


def job_fit(spec, mesh, results):
    """Occupancy-guided, stratified, fused fit over the mesh."""
    model = model_from(spec)
    train = ImageDataset.load(spec["scene"], "train", 16, stratified=True)
    val = ImageDataset.load(spec["scene"], "val", 16)
    base = train.sampler
    caster = Raycaster(model, fused_train=True)
    log = caster.fit(train, val, mesh=mesh, **spec["fit"])
    results["fit_psnr"] = np.array([[e.step, e.train_psnr, e.val_psnr]
                                    for e in log])
    results["fit_restored"] = np.array(train.sampler is base)
    save_params(results, "fit", model)


def job_fit_shared(spec, mesh, results):
    """Occupancy-guided, fused fit over the mesh without jitter, its
    epoch order read from the spec (the parent hands JAX's fit the same
    order), so its reports and weights can be held against JAX's."""
    model = model_from(spec)
    train = ImageDataset.load(spec["scene"], "train", 16)
    val = ImageDataset.load(spec["scene"], "val", 16)
    order = torch.from_numpy(np.load(spec["order"]))
    randperm = torch.randperm

    def shared(count, generator=None):
        assert count == len(order), (count, len(order))
        return order.clone()

    torch.randperm = shared
    try:
        log = Raycaster(model, fused_train=True).fit(train, val, mesh=mesh,
                                                     **spec["fit"])
    finally:
        torch.randperm = randperm
    results["fit_shared_psnr"] = np.array(
        [[e.step, e.train_psnr, e.val_psnr] for e in log])
    save_params(results, "fit_shared", model)


def frame_setup(spec):
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]), 3,
                    40.0, Resolution(20, 20), 3.0)
    grid = np.load(spec["grid"])
    sampler = OccupancyGridSampler(grid, 1.0, cameras, 12, num_probes=16,
                                   empty_weight=0.1, bounds=BOUNDS)
    return cameras, sampler, Raycaster(model_from(spec), fused=True)


def job_frame(spec, mesh, results):
    """A culled frame in ragged chunks of 50 and an early-terminated
    one, each rendered over the mesh."""
    _, sampler, caster = frame_setup(spec)
    results["frame"] = caster.render_frame(sampler, 0, chunk_size=50,
                                           mesh=mesh)
    results["frame_early"] = caster.render_frame(sampler, 1, chunk_size=50,
                                                 early_term=0.01, mesh=mesh)


def job_server(spec, mesh, results):
    """Rank 0 serves a rig frame and a pose frame; the others follow."""
    cameras, sampler, caster = frame_setup(spec)
    if not mesh.is_primary:
        results["followed"] = np.array(follow(caster, sampler, mesh,
                                              chunk_size=50))
        return
    server = RenderServer(caster, sampler, chunk_size=50, mesh=mesh)
    try:
        results["served"] = server.frame(1)
        results["served_pose"] = server.frame_pose(cameras[2].extrinsics)
    finally:
        server.close()


JOBS = {"steps": job_steps, "multi": job_multi, "fit": job_fit,
        "fit_shared": job_fit_shared, "frame": job_frame,
        "server": job_server}


def main():
    rank, world, port = (int(v) for v in sys.argv[1:4])
    with open(sys.argv[4]) as handle:
        spec = json.load(handle)
    torch.set_num_threads(1)
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                  device="cpu")
    mesh = make_mesh("cpu")
    assert (mesh.size, mesh.rank) == (world, rank)
    results = {}
    try:
        for job in spec["jobs"]:
            JOBS[job](spec, mesh, results)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **results)


if __name__ == "__main__":
    main()
