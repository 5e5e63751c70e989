"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors how the rebuild is validated without multi-chip hardware: JAX's
``xla_force_host_platform_device_count`` simulates the device mesh on CPU
(the reference has no multi-node tests at all — SURVEY.md §4).

Note: pytest plugins (jaxtyping) import jax before this file runs, so
setting ``JAX_PLATFORMS`` via the environment is too late — we update the
jax config directly, which is allowed until the first backend access.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Keep test (CPU) compile artifacts OUT of the user's warm-open cache
# (~/.cache/thz_image_explorer_tpu/xla holds the TPU programs the product
# reloads on warm opens; mixing in per-test CPU AOT results pollutes it
# and triggers machine-feature-mismatch warnings on reload). A stable tmp
# path still makes test reruns fast.
os.environ.setdefault("THZ_XLA_CACHE", "/tmp/thz-test-xla-cache")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (a hand-written kernel); skips without one")


@pytest.fixture(autouse=True)
def _isolated_config_dir(tmp_path, monkeypatch):
    """Point the settings/psf-tool persistence at a per-test directory so
    tests never read or write the user's real config."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg"))
