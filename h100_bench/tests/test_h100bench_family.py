"""A model family joins the benchmark as new files and new entries in
``BENCHMARK.json`` alone. In a copy of the harness, a throwaway family on
the port's dense ``Voxels`` field (with its plain trilinear reference),
its configuration, a mix of kind ``train``, its limits and a cell run
through ``run_cell`` at a tiny size, correct; no file that was there
changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from h100_bench.spec import BENCH_DIR, REPO_DIR

FAMILY = '''"""A throwaway family: the port's dense ``Voxels`` field, read by
trilinear interpolation with border clamping; its reference in plain
float32."""

from types import SimpleNamespace

import torch

from ..reference.model import fp8_round
from ..weights import assign

TINY = {}
# 8 corners x 4 channels, a multiply-add each; no kernel of the port runs
counts = SimpleNamespace(forward_flops=lambda cfg: 64,
                         step_flops=lambda cfg: 192,
                         forward_bounds=lambda cfg, points: {},
                         step_bounds=lambda cfg, points: {})


def leaf_specs(cfg):
    side = cfg["side"]
    return [("voxels", (1, 4, side, side, side), 1.0), ("bias", (4,), 1.0)]


def program(cfg, flat, device):
    from fourier_feature_nets_torch.models.voxels import Voxels
    model = Voxels(cfg["side"], cfg["scale"]).to(device)
    assign(model, flat, leaf_specs(cfg))
    return model


class PlainVoxels(torch.nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        side = cfg["side"]
        self.scale = cfg["scale"]
        self.voxels = torch.nn.Parameter(
            torch.zeros(1, 4, side, side, side, device=device))
        self.bias = torch.nn.Parameter(torch.zeros(4, device=device))

    def forward(self, points, views, quant=None):
        grid = self.voxels[0]
        if quant == "fp8":
            grid = fp8_round(grid)
        side = grid.shape[-1]
        # texel centres at (i + 0.5) / side * 2 - 1, clamped at the border
        u = torch.clamp(((points / self.scale + 1.0) * side - 1.0) / 2.0,
                        0, side - 1)
        low = torch.floor(u)
        frac = u - low
        low = low.long()
        high = torch.clamp(low + 1, max=side - 1)
        out = torch.zeros(points.shape[0], 4, device=points.device)
        for corner in range(8):
            up = [(corner >> axis) & 1 for axis in range(3)]
            x, y, z = (high[:, a] if up[a] else low[:, a] for a in range(3))
            weight = torch.ones_like(frac[:, 0])
            for a in range(3):
                weight = weight * (frac[:, a] if up[a] else 1 - frac[:, a])
            out = out + weight[:, None] * grid[:, z, y, x].T
        return out + self.bias


def reference(cfg, flat, device):
    model = PlainVoxels(cfg, device)
    assign(model, flat, leaf_specs(cfg))
    return model
'''
CONFIG = {"name": "voxels-16", "model": "toyvoxels", "side": 16,
          "scale": 1.0, "compute_dtype": "float32",
          "source": "the port's models/voxels.py", "reduced": []}
LIMITS = {"loss_gap": 1e-4, "grad_diff": 1e-3, "change_gap": 1e-3,
          "late_loss_gap": 1e-3, "late_change_gap": 1e-2}
RUN = """
import json, sys
sys.path[:0] = [{copy!r}, {repo!r}]
import h100_bench
from h100_bench.run import run_cell
from h100_bench.spec import load_benchmark
from h100_bench.tests.tiny import tiny_parts
bench = load_benchmark()
result = run_cell(bench, "train-voxels-16", 2 ** 31 + 3, 0.3, False, "cpu",
                  0.0, tiny_parts("train-voxels-16", bench))
print(json.dumps(dict(result, harness=h100_bench.__file__)))
"""


def _digests(root):
    out = {}
    for folder, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(folder, name)
            with open(path, "rb") as handle:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    handle.read()).hexdigest()
    return out


def test_a_new_family_joins_as_new_files_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, copy / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(REPO_DIR / "BENCHMARK.json", copy / "BENCHMARK.json")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    before = _digests(copy / "h100_bench")

    harness = copy / "h100_bench"
    (harness / "families" / "toyvoxels.py").write_text(FAMILY)
    (harness / "configs" / "voxels-16.json").write_text(json.dumps(CONFIG))
    mix = json.loads((harness / "traffic" / "train-synthetic.json")
                     .read_text())
    mix["why"] = "train_nerf's step on the synthetic scene, dense voxels"
    (harness / "traffic" / "train-voxels.json").write_text(json.dumps(mix))
    (harness / "limits" / "train-voxels-16.json").write_text(
        json.dumps(LIMITS))
    grown = dict(bench, configs=bench["configs"] + [
        {"name": "voxels-16", "source": "https://github.com/matajoh/"
         "fourier_feature_nets", "file": "h100_bench/configs/voxels-16.json",
         "reduced": [], "why": "a dense voxel field"}],
        workloads=bench["workloads"] + [
            {"name": "train-voxels-16", "config": "voxels-16",
             "traffic": "train-voxels", "chips": 1, "why": "voxels"}])
    (copy / "BENCHMARK.json").write_text(json.dumps(grown, indent=1))

    done = subprocess.run(
        [sys.executable, "-c", RUN.format(copy=str(copy),
                                          repo=str(REPO_DIR))],
        capture_output=True, text=True, timeout=600, cwd=copy,
        env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["harness"].startswith(str(copy))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == set(LIMITS)

    after = _digests(copy / "h100_bench")
    assert {name: after[name] for name in before} == before
    assert sorted(set(after) - set(before)) == sorted([
        os.path.join("families", "toyvoxels.py"),
        os.path.join("configs", "voxels-16.json"),
        os.path.join("traffic", "train-voxels.json"),
        os.path.join("limits", "train-voxels-16.json")])
