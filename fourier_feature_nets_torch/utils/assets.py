"""Known-asset registry, the data cache and the downloader.

Port of ``fourier_feature_nets_tpu/utils/assets.py``: the same 34 names
and OneDrive share links (12 datasets, 20 reference ``.pt`` checkpoints,
2 octree scenes) and the same direct-URL encoding. The cache is
``$FFN_TORCH_DATA_DIR`` or ``~/.cache/fourier_feature_nets_torch``;
datasets sit at its top, model checkpoints under ``models/``.

:func:`download_asset` streams with the standard library's
``urllib.request`` (30 s timeout) where the JAX package uses
``requests``, which the card's machine does not have: there the JAX
module's import of it fails and the download returns False. Any failure
(no network, an HTTP error, a dropped stream) prints the asset's name
and the error and returns False, leaving neither the file nor its
``.partial`` copy. :func:`resolve_asset` is the lookup the loaders
share: the path itself, else its cached copy, else a download of a
known asset into the cache, else ``FileNotFoundError``.
"""

import base64
import os
import urllib.request

__all__ = ["ASSETS", "default_data_dir", "download_asset", "resolve_asset"]

_ONEDRIVE = {
    "antinous_400.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluBagOAnmTej7LJb_Q",
    "antinous_800.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluIjnhVcVei5mZMIpw",
    "benin_400.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluIX9MtESyi1LX9L8Q",
    "benin_800.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluIlZRDTjHdSQnt_2A",
    "lego_400.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluBbbdxzOG5q4a98yA",
    "lego_800.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluIb8oRozVWUMQCfmg",
    "matthew_400.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluIz9A0gFTi-yBs8zQ",
    "matthew_800.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluI0rBTyq9jSnd4IjA",
    "rubik_400.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluI60mrfqAcxYIsdLg",
    "rubik_800.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluI7DdBRXbBngRMEew",
    "trex_400.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluM59kAfIq0H1AVdQA",
    "trex_800.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluM63nCZzfryxRR7ow",
}

_PRETRAINED = {
    # the reference's trained checkpoints, in its .pt format
    "antinous_800_vox128.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJLoo7yjPYQz8W5dg",
    "antinous_800_nerf.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJclttRvj65vHpUiA",
    "benin_800_vox128.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJNUlKmPZJiZ3HUlg",
    "benin_800_nerf.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJd2newCq4oVIlrXw",
    "lego_800_vox128.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJM8A6nLNsSxgaZLw",
    "lego_800_nerf.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJeY79jz1o51K4CIg",
    "matthew_800_vox128.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJOcOc6Ce3ZUcQl3g",
    "matthew_800_nerf.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJf0KKODbTR291vwQ",
    "trex_800_vox128.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluM74RKvya3PjvzqTw",
    "trex_800_nerf.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluNNxRr0lxo_U8-Kmg",
    "antinous_400_mlp.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJqpdzBhx9QAtbJ-g",
    "antinous_400_pos.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJokd4Fl4UGLI_bNw",
    "benin_400_mlp.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJlhzc0JjMUus5HsA",
    "benin_400_pos.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJkAd3De0s2DR_RoA",
    "lego_400_mlp.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJnRCQdmHfJiXvGNw",
    "lego_400_pos.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJrPmpRYZlP0fP5Eg",
    "matthew_400_mlp.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJmKYDqQpitLHVIHg",
    "matthew_400_pos.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluJpn1o7zC8uhdSDXA",
    "trex_400_mlp.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluNLAlM2t9uTqFO5DA",
    "trex_400_pos.pt": "https://1drv.ms/u/s!AnWvK2b51nGqluNMcZoNeFnSwCnSNw",
}

_OCTREES = {
    # pre-built octree scenes
    "antinous_octree_8.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluJt3FR8NAJW84HT2A",
    "antinous_octree_10.npz": "https://1drv.ms/u/s!AnWvK2b51nGqluJupuBKuwq0hYk-Tw",
}

#: Every known asset: 12 datasets, 20 reference checkpoints, 2 octrees.
ASSETS = {**_ONEDRIVE, **_PRETRAINED, **_OCTREES}

_CHUNK = 1 << 16
_TIMEOUT_S = 30


def default_data_dir() -> str:
    """Where downloaded and generated data is cached:
    ``$FFN_TORCH_DATA_DIR`` or ``~/.cache/fourier_feature_nets_torch``."""
    root = os.environ.get("FFN_TORCH_DATA_DIR")
    if root:
        return root
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "fourier_feature_nets_torch")


def _onedrive_direct_url(share_link: str) -> str:
    """Converts a OneDrive share link to a direct-download URL."""
    data = base64.b64encode(share_link.encode("utf-8")).decode("utf-8")
    data = data.replace("/", "_").replace("+", "-").rstrip("=")
    return f"https://api.onedrive.com/v1.0/shares/u!{data}/root/content"


def download_asset(name: str, output_path: str) -> bool:
    """Downloads a known asset to ``output_path``. Returns False on any
    failure (unknown asset, no network, HTTP error, a dropped stream)
    instead of raising; the file appears only when the whole body
    arrived."""
    if name not in ASSETS:
        print("Unrecognized asset:", name)
        return False
    partial_path = output_path + ".partial"
    try:
        url = _onedrive_direct_url(ASSETS[name])
        with urllib.request.urlopen(url, timeout=_TIMEOUT_S) as response:
            os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                        exist_ok=True)
            expected = response.headers.get("Content-Length")
            written = 0
            with open(partial_path, "wb") as file:
                while chunk := response.read(_CHUNK):
                    file.write(chunk)
                    written += len(chunk)
            # a body cut short ends the reads quietly, without a raise
            if expected is not None and written != int(expected):
                raise OSError(f"the stream ended after {written} of "
                              f"{expected} bytes")
        os.replace(partial_path, output_path)
        return True
    except Exception as error:  # offline, HTTP error or a dropped stream
        print(f"Unable to download {name}: {error}")
        return False
    finally:
        if os.path.exists(partial_path):
            os.unlink(partial_path)


def resolve_asset(path: str, kind: str = "dataset", subdir: str = "",
                  download: bool = True) -> str:
    """A local file for ``path``: the path itself if it exists, else
    ``default_data_dir()/subdir/<basename>`` if that exists, else (with
    ``download``) that cached copy freshly downloaded, when the basename
    is a known asset.

    Raises:
        FileNotFoundError: naming the path and the cache path, and the
            asset when its download failed.
    """
    if os.path.exists(path):
        return path
    name = os.path.basename(path)
    cached = os.path.join(default_data_dir(), subdir, name)
    if os.path.exists(cached):
        return cached
    if name not in ASSETS:
        raise FileNotFoundError(
            f"{path}: no such file, no cached copy at {cached}, and "
            f"{name!r} is not a known asset")
    if download:
        print(f"Downloading {kind}...")
        if download_asset(name, cached):
            return cached
    raise FileNotFoundError(
        f"{path}: known asset {name!r} could not be downloaded to {cached} "
        "(offline?)")
