"""The port's asset registry, data cache and downloader against the JAX
package's, on the CPU and without the network.

Held: the registry and its direct-URL encoding equal JAX's; the cache
directory follows ``FFN_TORCH_DATA_DIR``; ``download_asset`` streams a
body from a server on 127.0.0.1 (or a ``file://`` URL) into place and
returns False, leaving neither the file nor its ``.partial``, for a
stream cut short (by length and chunked), an HTTP 404, a refused
connection and an unknown name; ``load_model``, ``ImageDataset.load``,
``resolve_data_path`` and ``distill_model --data`` read a cached copy,
and one that a download writes, and raise ``FileNotFoundError`` for a
file they can neither find nor download; under two gloo ranks one
download happens, on rank 0; the package never imports ``requests``.
Every download here is served from 127.0.0.1 or a monkeypatched
``download_asset``: no test opens a connection beyond this host.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest

import fourier_feature_nets_torch as port_api
import fourier_feature_nets_tpu as ffn
from fourier_feature_nets_torch.cli import common as port_common
from fourier_feature_nets_torch.cli import distill_model as port_distill_cli
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.models import load_model as port_load_model
from fourier_feature_nets_torch.models import params_to_jax
from fourier_feature_nets_torch.models import save_torch_model
from fourier_feature_nets_torch.utils import assets
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.utils import assets as jax_assets
from test_torch_parallel import WORKER, _env, _free_port, _join

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "fourier_feature_nets_torch")
BODY = bytes(np.random.default_rng(0).integers(0, 256, 200_000, np.uint8))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    return generate_synthetic_dataset(path, resolution=16,
                                      split_counts=(3, 1, 1),
                                      volume_side=16, num_samples=32)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An empty data cache in ``FFN_TORCH_DATA_DIR`` and a working
    directory without the asset."""
    root = tmp_path / "cache"
    monkeypatch.setenv("FFN_TORCH_DATA_DIR", str(root))
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    return root


def _fake_download(source, calls=None):
    """A ``download_asset`` that copies ``source`` to the output path."""
    def download(name, path):
        if calls is not None:
            calls.append(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        shutil.copyfile(source, path)
        return True
    return download


def _no_download(name, path):
    raise AssertionError(f"{name} was downloaded although it is cached")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_assets_equal_jax():
    assert assets.ASSETS == jax_assets.ASSETS
    assert len(assets.ASSETS) == 34
    assert sum(name.endswith(".pt") for name in assets.ASSETS) == 20
    assert port_api.download_asset is assets.download_asset


@pytest.mark.parametrize("name", sorted(jax_assets.ASSETS))
def test_direct_url_equals_jax(name):
    link = jax_assets.ASSETS[name]
    url = assets._onedrive_direct_url(link)
    assert url == jax_assets._onedrive_direct_url(link)
    assert url.startswith("https://api.onedrive.com/v1.0/shares/u!")
    assert "=" not in url and "+" not in url


def test_default_data_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("FFN_TORCH_DATA_DIR", str(tmp_path / "d"))
    assert assets.default_data_dir() == str(tmp_path / "d")
    monkeypatch.delenv("FFN_TORCH_DATA_DIR")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert assets.default_data_dir() == str(
        tmp_path / ".cache" / "fourier_feature_nets_torch")
    assert not hasattr(port_common, "data_dir")


# ---------------------------------------------------------------------------
# the downloader, against a server on 127.0.0.1
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def do_GET(self):
        self.close_connection = True
        files = self.server.files
        if self.path in files:
            body = files[self.path]
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/drop":
            self.send_response(200)
            self.send_header("Content-Length", str(len(BODY)))
            self.end_headers()
            self.wfile.write(BODY[:len(BODY) // 3])
        elif self.path == "/chunked-drop":
            self.send_response(200)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self.wfile.write(b"1000\r\n" + BODY[:4096] + b"\r\n")
        else:
            self.send_error(404)


@pytest.fixture(scope="module")
def server():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    httpd.files = {"/ok": BODY}
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()


def _serve_from(monkeypatch, url):
    """Points every asset's direct URL at ``url``."""
    monkeypatch.setattr(assets, "_onedrive_direct_url", lambda link: url)


def _url(server, path):
    return f"http://127.0.0.1:{server.server_address[1]}{path}"


def test_download_streams_the_body(server, monkeypatch, tmp_path):
    _serve_from(monkeypatch, _url(server, "/ok"))
    out = tmp_path / "sub" / "lego_400.npz"
    assert assets.download_asset("lego_400.npz", str(out)) is True
    assert out.read_bytes() == BODY
    assert os.listdir(out.parent) == ["lego_400.npz"]


def test_download_from_a_file_url(monkeypatch, tmp_path):
    source = tmp_path / "source.bin"
    source.write_bytes(BODY)
    _serve_from(monkeypatch, source.as_uri())
    out = tmp_path / "trex_800_nerf.pt"
    assert assets.download_asset("trex_800_nerf.pt", str(out)) is True
    assert out.read_bytes() == BODY
    assert not os.path.exists(str(out) + ".partial")


@pytest.mark.parametrize("path,reason", [
    ("/drop", "ended after 66666 of 200000 bytes"),
    ("/chunked-drop", "IncompleteRead"),
    ("/missing", "HTTP Error 404"),
    ("refused", "Connection refused")])
def test_failed_download_leaves_no_file(server, path, reason, monkeypatch,
                                        tmp_path, capsys):
    if path == "refused":
        url = f"http://127.0.0.1:{_free_port()}/ok"   # nothing listens
    else:
        url = _url(server, path)
    _serve_from(monkeypatch, url)
    out = tmp_path / "lego_800.npz"
    assert assets.download_asset("lego_800.npz", str(out)) is False
    assert os.listdir(tmp_path) == []
    said = capsys.readouterr().out
    assert "Unable to download lego_800.npz" in said and reason in said


def test_unknown_asset_is_refused(monkeypatch, tmp_path, capsys):
    _serve_from(monkeypatch, "http://127.0.0.1:9/never-fetched")
    out = tmp_path / "no-such-asset"
    assert assets.download_asset("no-such-asset", str(out)) is False
    assert os.listdir(tmp_path) == []
    assert "Unrecognized asset: no-such-asset" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# load_model
# ---------------------------------------------------------------------------

def _jax_model(tmp_path):
    model = ffn.NeRF(num_layers=2, num_channels=16, max_log_scale_pos=3.0,
                     num_freq_pos=4, max_log_scale_view=1.0, num_freq_view=2,
                     skips=[1], include_inputs=True)
    params = model.init(jax.random.PRNGKey(0))
    path = str(tmp_path / "teacher.npz")
    ffn.save_model(model, params, path)
    return path, {k: np.asarray(v) for k, v in _flatten(params).items()}


def _assert_params(model, expected):
    got = params_to_jax(model)
    assert set(got) == set(expected)
    for key, value in expected.items():
        np.testing.assert_array_equal(got[key], value)


def test_load_model_reads_the_cache(cache, tmp_path, monkeypatch):
    source, expected = _jax_model(tmp_path)
    os.makedirs(cache / "models")
    shutil.copyfile(source, cache / "models" / "mine.npz")
    monkeypatch.setattr(assets, "download_asset", _no_download)
    _assert_params(port_load_model("mine.npz"), expected)
    _assert_params(port_load_model("elsewhere/mine.npz"), expected)


def test_load_model_downloads_a_known_asset(cache, tmp_path, monkeypatch,
                                            capsys):
    """A JAX-written checkpoint, through a monkeypatched downloader as
    the JAX suite's ``test_known_asset_downloaded_is_loaded`` does, and
    a reference ``.pt`` through the real downloader from 127.0.0.1."""
    source, expected = _jax_model(tmp_path)
    calls = []
    monkeypatch.setattr(assets, "download_asset",
                        _fake_download(source, calls))
    monkeypatch.setitem(assets.ASSETS, "tiny_test_model.npz", "x")
    _assert_params(port_load_model("tiny_test_model.npz"), expected)
    assert calls == ["tiny_test_model.npz"]
    assert os.path.exists(cache / "models" / "tiny_test_model.npz")
    assert "Downloading model..." in capsys.readouterr().out
    # cached now: no second download
    _assert_params(port_load_model("tiny_test_model.npz"), expected)
    assert calls == ["tiny_test_model.npz"]


def test_load_model_downloads_over_http(server, cache, tmp_path,
                                        monkeypatch):
    model = port_load_model(_jax_model(tmp_path)[0])
    pt = tmp_path / "served.pt"
    save_torch_model(model, str(pt))
    server.files["/model.pt"] = pt.read_bytes()
    _serve_from(monkeypatch, _url(server, "/model.pt"))
    loaded = port_load_model("lego_800_nerf.pt")
    _assert_params(loaded, params_to_jax(model))
    assert os.listdir(cache / "models") == ["lego_800_nerf.pt"]


def test_load_model_missing_raises(cache, tmp_path, monkeypatch):
    monkeypatch.setattr(assets, "download_asset", lambda name, path: False)
    with pytest.raises(FileNotFoundError, match="lego_800_nerf.pt.*offline"):
        port_load_model("lego_800_nerf.pt")
    with pytest.raises(FileNotFoundError, match="not a known asset"):
        port_load_model(str(tmp_path / "nope.npz"))
    with pytest.raises(FileNotFoundError):
        ffn.load_model(str(tmp_path / "nope.npz"))


# ---------------------------------------------------------------------------
# ImageDataset.load and resolve_data_path
# ---------------------------------------------------------------------------

def _assert_dataset(ours, scene):
    ref = ffn.ImageDataset.load(scene, "train", 8)
    assert ours.num_cameras == ref.num_cameras
    np.testing.assert_array_equal(ours.colors.numpy(), np.asarray(ref.colors))


def test_dataset_load_reads_the_cache(cache, scene, monkeypatch):
    os.makedirs(cache)
    shutil.copyfile(scene, cache / "mine.npz")
    monkeypatch.setattr(assets, "download_asset", _no_download)
    _assert_dataset(TorchDataset.load("mine.npz", "train", 8), scene)


def test_dataset_load_downloads_a_known_asset(cache, scene, monkeypatch,
                                              capsys):
    calls = []
    monkeypatch.setattr(assets, "download_asset",
                        _fake_download(scene, calls))
    _assert_dataset(TorchDataset.load("lego_400.npz", "train", 8), scene)
    assert calls == ["lego_400.npz"]
    assert os.listdir(cache) == ["lego_400.npz"]
    assert "Downloading dataset..." in capsys.readouterr().out


def test_dataset_load_missing_raises(cache, monkeypatch):
    monkeypatch.setattr(assets, "download_asset", lambda name, path: False)
    cached = os.path.join(str(cache), "lego_400.npz")
    with pytest.raises(FileNotFoundError,
                       match=f"'lego_400.npz'.*{re.escape(cached)}"):
        TorchDataset.load("lego_400.npz", "train", 8)
    with pytest.raises(FileNotFoundError, match="not a known asset"):
        TorchDataset.load("mine.npz", "train", 8)


def test_resolve_data_path_falls_back_to_the_cache(cache, scene,
                                                   monkeypatch, tmp_path):
    from fourier_feature_nets_tpu.cli.common import (
        resolve_data_path as jax_resolve,
    )
    monkeypatch.setenv("FFN_TPU_DATA_DIR", str(cache))
    os.makedirs(cache)
    shutil.copyfile(scene, cache / "mine.npz")
    monkeypatch.setattr(assets, "download_asset", _no_download)
    expected = str(cache / "mine.npz")
    assert port_common.resolve_data_path("mine.npz") == expected
    assert jax_resolve("mine.npz") == expected
    assert port_common.resolve_data_path(scene) == scene
    calls = []
    monkeypatch.setattr(assets, "download_asset",
                        _fake_download(scene, calls))
    assert port_common.resolve_data_path("trex_400.npz") == str(
        cache / "trex_400.npz")
    assert calls == ["trex_400.npz"]
    with pytest.raises(FileNotFoundError):
        port_common.resolve_data_path(str(tmp_path / "nope.npz"))


def test_download_once_on_rank_0(scene, tmp_path):
    """Two gloo ranks resolve a known dataset missing from their shared
    cache: rank 0 downloads it while rank 1 waits, then both read it."""
    out = tmp_path / "ranks"
    out.mkdir()
    spec = dict(jobs=["download"], out=str(out), scene=scene,
                asset="lego_400.npz")
    with open(out / "spec.json", "w") as handle:
        json.dump(spec, handle)
    env = _env()
    env["FFN_TORCH_DATA_DIR"] = str(tmp_path / "cache")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(rank), "2", str(port),
         str(out / "spec.json")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for rank in range(2)]
    _join(procs)
    results = [dict(np.load(out / f"rank{rank}.npz")) for rank in range(2)]
    assert [int(r["downloads"]) for r in results] == [1, 0]
    cached = str(tmp_path / "cache" / "lego_400.npz")
    assert [str(r["path"]) for r in results] == [cached, cached]
    assert [int(r["train_cameras"]) for r in results] == [3, 3]


# ---------------------------------------------------------------------------
# distill_model --data
# ---------------------------------------------------------------------------

DISTILL = ["--device", "cpu", "--student-layers", "2", "--student-channels",
           "16", "--batch-rays", "16", "--num-samples", "8", "--num-steps",
           "2", "--steps-per-call", "2", "--uniform"]


@pytest.mark.parametrize("how", ["cached", "downloaded"])
def test_distill_reads_the_cached_npz(how, cache, scene, tmp_path,
                                      monkeypatch, capsys):
    teacher, _ = _jax_model(tmp_path)
    name = "mine.npz" if how == "cached" else "lego_400.npz"
    if how == "cached":
        os.makedirs(cache)
        shutil.copyfile(scene, cache / name)
        monkeypatch.setattr(assets, "download_asset", _no_download)
    else:
        monkeypatch.setattr(assets, "download_asset", _fake_download(scene))
    assert port_distill_cli.main([teacher, str(tmp_path / "out"), "--data",
                                  name, *DISTILL]) == 0
    assert "student val PSNR" in capsys.readouterr().out
    assert not os.path.exists(name)


# ---------------------------------------------------------------------------
# no requests, no network library beyond the standard one
# ---------------------------------------------------------------------------

def test_the_port_never_imports_requests():
    code = ("import sys, fourier_feature_nets_torch, "
            "fourier_feature_nets_torch.utils.assets, "
            "fourier_feature_nets_torch.cli.common; "
            "print('requests' in sys.modules)")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          check=True, env=dict(os.environ, PYTHONPATH=ROOT))
    assert done.stdout.strip() == "False"
    banned = re.compile(r"^\s*(import|from)\s+requests\b", re.M)
    for folder, _, files in os.walk(PORT_DIR):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(folder, name)) as handle:
                    assert not banned.search(handle.read()), name
