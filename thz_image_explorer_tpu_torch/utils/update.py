"""Software-update check.

The port's own copy of ``thz_image_explorer_tpu/utils/update.py``, the
equivalent of the reference's self-update subsystem (``update.rs:1-211``):
semver comparison against the latest published release of this package
and an in-place install. Offline, :func:`latest_release` gives None and
the check reports the latest version as "unknown" instead of failing.
"""

from __future__ import annotations

import http.client
import json
import os
import re
import urllib.error
import urllib.request
from typing import Optional

from thz_image_explorer_tpu_torch import __version__

#: release endpoint of this repository (overridable for mirrors and forks,
#: and for tests, which point it at a local address); its tarballs carry
#: the ``thz_image_explorer_tpu_torch/`` tree the install replaces
RELEASES_URL = os.environ.get(
    "THZ_UPDATE_RELEASES_URL",
    "https://api.github.com/repos/unibe-icelab/thz-image-explorer-tpu/"
    "releases/latest",
)


def parse_version(v: str) -> tuple[int, int, int]:
    m = re.match(r"v?(\d+)\.(\d+)\.(\d+)", v.strip())
    if not m:
        raise ValueError(f"not a semver string: {v!r}")
    return tuple(int(g) for g in m.groups())  # type: ignore[return-value]


def is_newer(candidate: str, current: str) -> bool:
    return parse_version(candidate) > parse_version(current)


def latest_release(timeout: float = 5.0) -> Optional[str]:
    """The latest release's tag, or None when the release server cannot be
    reached (or answers without one): the latest version is then unknown."""
    try:
        with urllib.request.urlopen(RELEASES_URL, timeout=timeout) as r:
            data = json.load(r)
        return data.get("tag_name", "") or None
    except (urllib.error.URLError, http.client.HTTPException, OSError,
            ValueError, AttributeError):
        return None


def check_for_updates(
    current: str = __version__, timeout: float = 5.0
) -> Optional[str]:
    """Return the newer version tag if one exists, None when up to date,
    and None (with no error) when the network is unavailable."""
    tag = latest_release(timeout)
    try:
        return tag if tag and is_newer(tag, current) else None
    except ValueError:
        return None


def fetch_release_tarball_url(timeout: float = 5.0) -> Optional[tuple[str, str]]:
    """(tag, tarball_url) of the latest release, or None offline."""
    try:
        with urllib.request.urlopen(RELEASES_URL, timeout=timeout) as r:
            data = json.load(r)
        tag, url = data.get("tag_name", ""), data.get("tarball_url", "")
        return (tag, url) if tag and url else None
    except (urllib.error.URLError, http.client.HTTPException, OSError,
            ValueError):
        return None


def install_update(
    tarball_url: str,
    package_dir: Optional[str] = None,
    timeout: float = 30.0,
) -> str:
    """Download a release tarball and atomically replace the installed
    package with its ``thz_image_explorer_tpu_torch/`` tree — the Python-package
    equivalent of the reference's binary self-replace
    (``update.rs:118-211``: download asset → extract to temp dir →
    ``self_replace``). The previous installation is kept as a ``.bak``
    sibling and restored on any failure.

    Returns the path of the replaced package directory. Raises on any
    error (network, malformed archive, permissions) after rolling back.
    """
    import shutil
    import tarfile
    import tempfile

    import thz_image_explorer_tpu_torch as pkg

    if package_dir is None:
        package_dir = os.path.dirname(os.path.abspath(pkg.__file__))

    tmp = tempfile.mkdtemp(prefix="thz_update_")
    try:
        archive = os.path.join(tmp, "release.tar.gz")
        with urllib.request.urlopen(tarball_url, timeout=timeout) as r, open(
            archive, "wb"
        ) as f:
            shutil.copyfileobj(r, f)

        extract_dir = os.path.join(tmp, "x")
        with tarfile.open(archive, "r:*") as tf:
            tf.extractall(extract_dir, filter="data")

        # locate the package tree inside the archive (GitHub tarballs nest
        # everything under <repo>-<sha>/)
        new_pkg = None
        for root, dirs, _files in os.walk(extract_dir):
            if os.path.basename(root) == "thz_image_explorer_tpu_torch" and \
                    os.path.isfile(os.path.join(root, "__init__.py")):
                new_pkg = root
                break
        if new_pkg is None:
            raise ValueError("archive contains no thz_image_explorer_tpu_torch/ package")

        backup = package_dir.rstrip("/\\") + ".bak"
        if os.path.exists(backup):
            shutil.rmtree(backup)
        os.replace(package_dir, backup)
        try:
            shutil.move(new_pkg, package_dir)
        except Exception:
            # rollback: discard any partially-copied tree (cross-device
            # moves degrade to copytree and can fail midway), then put
            # the previous installation back
            if os.path.exists(package_dir):
                shutil.rmtree(package_dir, ignore_errors=True)
            os.replace(backup, package_dir)
            raise
        return package_dir
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
