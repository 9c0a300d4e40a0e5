"""Sample data retrieval from Zenodo (reference ``pyorc/sample_data.py:13-97``).

The JAX package's :mod:`pyorc_tpu.sample_data` on the port: urllib with a
checksum check instead of pooch, the same cache (``PYORC_TPU_CACHE``, else
``~/.cache/pyorc_tpu``) and the same files. urllib is imported inside the
functions, and nothing touches the network until one is called. Where there
is no network a download fails fast with an error that says where to put the
file by hand.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Optional

__all__ = ["get_hommerich_dataset", "get_hommerich_pyorc_files", "cache_path"]

ZENODO_RECORD = "14159228"
BASE_URL = f"https://zenodo.org/records/{ZENODO_RECORD}/files"
OUTPUTS_URL = "https://zenodo.org/records/15002591/files"

FILES = {
    "20240718_162737.mp4": None,  # Hommerich sample video (checksum optional)
    "cs1.geojson": None,
    "cam_config_gcps.json": None,
}


def cache_path() -> Path:
    path = Path(os.environ.get("PYORC_TPU_CACHE", Path.home() / ".cache" / "pyorc_tpu"))
    path.mkdir(parents=True, exist_ok=True)
    return path


def _fetch(fname: str, sha256: Optional[str] = None, base_url: str = BASE_URL) -> str:
    """The cached path of ``fname``, downloaded from ``base_url`` on first use; a file
    whose SHA-256 is not ``sha256`` is removed and raises."""
    import urllib.request

    dest = cache_path() / fname
    if dest.is_file():
        return str(dest)
    url = f"{base_url}/{fname}"
    try:
        urllib.request.urlretrieve(url, dest)  # noqa: S310
    except Exception as e:
        raise IOError(
            f"Could not download sample data from {url} ({e}). If this environment has no network "
            f"access, place the file manually at {dest}."
        ) from e
    if sha256 is not None:
        h = hashlib.sha256(dest.read_bytes()).hexdigest()
        if h != sha256:
            dest.unlink()
            raise IOError(f"Checksum mismatch for {fname}")
    return str(dest)


def zenodo_pooch(record_id, cache_name):
    """Fetch all files of a Zenodo record into the cache (reference
    sample_data.py:13-34 uses pooch; urllib here). Returns local paths."""
    import json
    import urllib.request

    meta_url = f"https://zenodo.org/api/records/{record_id}"
    try:
        with urllib.request.urlopen(meta_url, timeout=30) as r:  # noqa: S310
            meta = json.load(r)
    except Exception as e:
        raise RuntimeError(f"Failed to fetch metadata for record {record_id}: {e}") from e
    base_url = f"https://zenodo.org/records/{record_id}/files"
    return {f.get("key"): _fetch(f.get("key"), base_url=base_url) for f in meta.get("files", [])}


def get_hommerich_dataset() -> str:
    """Path to the Hommerich sample video (downloads on first use)."""
    return _fetch("20240718_162737.mp4", FILES["20240718_162737.mp4"])


def get_hommerich_pyorc_files():
    """Paths to the Hommerich cross-section + camera config files."""
    return _fetch("cs1.geojson", FILES["cs1.geojson"]), _fetch("cam_config_gcps.json", FILES["cam_config_gcps.json"])


def get_hommerich_pyorc_zip() -> str:
    """Path to the zipped Hommerich pyorc outputs (reference sample_data.py:62-85)."""
    return _fetch("hommerich_20241010_081717_pyorc_data.zip.zip", base_url=OUTPUTS_URL)
