"""The PyTorch port imports neither jax nor the JAX package, and needs
no CUDA to import."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "fourier_feature_nets_torch")

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import fourier_feature_nets_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import torch
from fourier_feature_nets_torch.octree import build as octree_build
print(json.dumps({
    "octree_library_loaded": octree_build._LIBRARY is not None,
    "modules": names,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                  or m.startswith("fourier_feature_nets_tpu")),
    "triton": "triton" in sys.modules,
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


@pytest.fixture(scope="module")
def imported():
    import json
    env = dict(os.environ, PYTHONPATH=ROOT)
    done = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120, check=False)
    assert done.returncode == 0, done.stderr
    return json.loads(done.stdout.strip().splitlines()[-1])


def _port_sources():
    for base, _, files in os.walk(PORT):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(base, name)


def test_every_module_imports_without_jax(imported):
    assert imported["jax"] == []


def test_walk_found_the_slice_modules(imported):
    expected = {
        "cameras", "utils.camera_paths", "utils.progress", "utils.png",
        "ops.encoding", "ops.intersection", "ops.sampling", "ops.blend",
        "models.module", "models.nerf", "models.serialization",
        "kernels.fused_nerf", "kernels.build", "render.ray_sampler",
        "render.occupancy_sampler", "render.raycaster", "cli.common",
        "cli.orbit_video", "ops.sampling", "utils.optim",
        "kernels.fused_nerf_train", "datasets.ray_dataset",
        "datasets.image_dataset", "datasets.synthetic", "visualizers",
        "cli.train_nerf", "kernels.fused_ray_render", "cli.validate_kernels",
        "kernels.int8_probe", "kernels.fused_nerf_ablation",
        "kernels.io_floor", "cli.int8_probe", "cli.kernel_ablation_bench",
        "cli.kernel_io_floor_bench", "octree", "octree.build", "octree.host",
        "octree.octree", "octree.traversal", "octree.mesh",
        "render.octree_sampler", "cli.voxelize_model", "cli.mesh_to_octree",
        "utils.color", "utils.checkpoint", "utils.jpeg", "ops.metrics",
        "render.server", "render.distill", "cli.serve", "cli.distill_model",
        "models.fourier", "models.voxels", "models.factorized",
        "datasets.pixel_dataset", "datasets.signal_dataset", "utils.image",
        "utils.layout",
        "cli.train_tiny_nerf", "cli.train_voxels",
        "cli.train_image_regression", "cli.train_signal_regression",
        "cli.convert_checkpoint",
        "ops.interpolation", "utils.debug", "utils.search", "mesh_export",
        "cli.export_mesh", "cli.sweep", "cli.inspect_ray_sampling",
        "utils.video", "cli.near_orbit", "parallel", "parallel.mesh",
        "parallel.data_parallel", "scenepic_io", "lecture",
        "lecture.figures", "lecture.animations"}
    found = {name.split(".", 1)[1] for name in imported["modules"]}
    assert expected <= found


def test_import_touches_no_gpu(imported):
    assert not imported["triton"]
    assert not imported["cuda_initialized"]


def test_import_builds_no_octree_library(imported):
    assert not imported["octree_library_loaded"]


def test_sources_name_no_jax_and_no_compile():
    banned = re.compile(r"^\s*(import jax|from jax|import fourier_feature_nets_tpu"
                        r"|from fourier_feature_nets_tpu)|torch\.compile\(",
                        re.MULTILINE)
    offenders = [path for path in _port_sources()
                 if banned.search(open(path).read())]
    assert offenders == []


def test_pkgutil_sees_port_package():
    names = [m.name for m in pkgutil.iter_modules([PORT])]
    assert {"kernels", "models", "ops", "render", "cli", "utils"} <= set(names)
