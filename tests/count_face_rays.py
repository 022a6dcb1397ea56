"""Counts the rays of a stride-2 culled frame whose final hit flag differs
between the JAX package's frame and the port's, with the port's probe
before its repair at cell faces (the plain gather) and after it.

The rig is ``--preset fast``'s: an orbit at distance 4 with a 40 degree
field of view, 48 samples, 800x800 frames. Culling depends on the grid,
not the model, so the model is a 2x32 NeRF whose opacity bias makes
every rendered ray non-black, and the frames' black masks are compared.
Two grids: bench.py's depth-6 tree through ``occupancy_grid_from_tree``
(64^3, pooled to the 32^3 probe table) and a sphere grid.

    JAX_PLATFORMS=cpu python tests/count_face_rays.py [--cameras 4] \
        [--resolution 800]

Prints one JSON line per grid and camera, then a summary line.
"""

import argparse
import json
import os
import sys
import time

import jax
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from fourier_feature_nets_torch.models import NeRF as TorchNeRF  # noqa: E402
from fourier_feature_nets_torch.models import params_from_jax  # noqa: E402
from fourier_feature_nets_torch.render import (  # noqa: E402
    OccupancyGridSampler as TorchOccupancy,
    Raycaster as TorchRaycaster,
)
from fourier_feature_nets_torch.render import (  # noqa: E402
    occupancy_grid_from_tree as torch_grid_from_tree,
)
from fourier_feature_nets_torch.octree import OcTree as TorchTree  # noqa: E402
from fourier_feature_nets_tpu.cameras import Resolution  # noqa: E402
from fourier_feature_nets_tpu.models import NeRF  # noqa: E402
from fourier_feature_nets_tpu.models.serialization import _flatten  # noqa: E402,E501
from fourier_feature_nets_tpu.render import Raycaster  # noqa: E402
from fourier_feature_nets_tpu.render.occupancy_sampler import (  # noqa: E402
    OccupancyGridSampler,
)
from fourier_feature_nets_tpu.utils.camera_paths import orbit  # noqa: E402
from face_probe import GatherHit  # noqa: E402

BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
CONFIG = dict(num_layers=2, num_channels=32, max_log_scale_pos=4.0,
              num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
              skips=[1], include_inputs=True)


def _grids():
    """{name: 64^3 grid}: bench.py's tree (its seeded cloud, depth 6,
    leaves of 2 points or more) and a sphere."""
    rng = np.random.default_rng(1)
    cloud = np.concatenate([rng.normal([0.2, 0.0, 0.0], 0.2, (20000, 3)),
                            [[-1, -1, -1], [1, 1, 1]]]).astype(np.float32)
    tree = TorchTree.build_from_samples(cloud, depth=6, min_leaf_size=2)
    c = (np.arange(64) + 0.5) / 64 * 2 - 1
    zz, yy, xx = np.meshgrid(c, c, c, indexing="ij")
    sphere = (np.sqrt((xx - 0.3) ** 2 + yy ** 2 + zz ** 2) < 0.45)
    return {"bench-tree-64": torch_grid_from_tree(tree, 64),
            "sphere-64": sphere.astype(np.float32)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cameras", type=int, default=4)
    parser.add_argument("--resolution", type=int, default=800)
    args = parser.parse_args(argv)
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    model = NeRF(**CONFIG)
    params = model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    flat["opacity_out/bias"] = np.full_like(flat["opacity_out/bias"], 6.0)
    params = dict(params)
    params["opacity_out"] = dict(params["opacity_out"],
                                 bias=jax.numpy.asarray(
                                     flat["opacity_out/bias"]))
    port = params_from_jax(TorchNeRF(**CONFIG), flat)
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, -1.0]),
                    args.cameras, 40.0,
                    Resolution(args.resolution, args.resolution), 4.0)
    totals = {}
    for name, grid in _grids().items():
        jax_sampler = OccupancyGridSampler(None, cameras, 48,
                                           empty_weight=0.1, bounds=BOUNDS,
                                           occupancy_grid=grid,
                                           grid_scale=1.0)
        sampler = TorchOccupancy(grid, 1.0, cameras, 48, empty_weight=0.1,
                                 bounds=BOUNDS)
        caster, ref_caster = TorchRaycaster(port), Raycaster(model)
        for camera in range(args.cameras):
            start = time.perf_counter()
            ref = ref_caster.render_frame(params, jax_sampler, camera)
            jax_s = time.perf_counter() - start
            ref_lit = ref.max(-1) > 0
            row = {"grid": name, "camera": camera, "jax_frame_s": jax_s,
                   "jax_lit": int(ref_lit.sum())}
            for label, probe in (("before", GatherHit(sampler)),
                                 ("after", sampler)):
                with torch.no_grad():
                    lit = caster.render_frame(probe, camera).max(-1) > 0
                row[label] = {
                    "differ": int((lit != ref_lit).sum()),
                    "black_in_port_only": int((ref_lit & ~lit).sum()),
                    "black_in_jax_only": int((lit & ~ref_lit).sum())}
            print(json.dumps(row), flush=True)
            for label in ("before", "after"):
                for key, value in row[label].items():
                    totals.setdefault(name, {}).setdefault(
                        label, {}).setdefault(key, 0)
                    totals[name][label][key] += value
    print(json.dumps({"summary": totals, "cameras": args.cameras,
                      "resolution": args.resolution}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
