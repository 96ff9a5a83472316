"""Dataset download / extraction helpers (the port's copy of
``timbre_trap_tpu/data/download.py``).

Functional parity with ``timbre_trap/utils/data.py:28-139`` using only the
standard library (urllib instead of requests).
"""

import os
import shutil
import tarfile
import urllib.request
import zipfile

__all__ = ["stream_url_resource", "unzip_and_remove", "change_base_dir"]


def stream_url_resource(url, save_path, chunk_size=1024 * 256):
    """Download a URL to ``save_path`` by streaming chunks."""
    print(f"Downloading {os.path.basename(url)}...")
    request = urllib.request.Request(url, headers={"User-Agent": "timbre-trap-tpu"})
    with urllib.request.urlopen(request) as response, open(save_path, "wb") as fh:
        total = response.headers.get("Content-Length")
        done = 0
        while True:
            chunk = response.read(chunk_size)
            if not chunk:
                break
            fh.write(chunk)
            done += len(chunk)
            if total:
                pct = 100.0 * done / int(total)
                print(f"\r  {done / 1e6:.1f}MB ({pct:.0f}%)", end="", flush=True)
        print()


def unzip_and_remove(zip_path, target=None, tar=False):
    """Extract a zip/tar archive next to itself (or into ``target``), then delete it."""
    print(f"Unzipping {os.path.basename(zip_path)}...")
    if target is None:
        target = os.path.dirname(zip_path)
    if tar:
        with tarfile.open(zip_path, "r") as tf:
            tf.extractall(target)
    else:
        with zipfile.ZipFile(zip_path, "r") as zf:
            zf.extractall(target)
    os.remove(zip_path)


def change_base_dir(new_dir, old_dir):
    """Move every entry of ``old_dir`` into ``new_dir`` and remove ``old_dir``."""
    for content in os.listdir(old_dir):
        shutil.move(os.path.join(old_dir, content), os.path.join(new_dir, content))
    os.rmdir(old_dir)
