"""Test harness config.

The CPU suite runs with ``JAX_PLATFORMS=cpu`` (the tier-1 command); then
this file gives the CPU backend 8 virtual devices so the sharding tests
have a mesh (SURVEY.md §4 "Multi-chip without a cluster"), and the
kernel tests run Pallas in interpret mode, which they ask for explicitly.

Tests that need a GPU carry the ``gpu`` marker and skip elsewhere; the
``gpu`` fixture in ``tests/test_gpu.py`` decides at run time.
``python chip_smoke.py`` runs them on the card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("JAX_PLATFORMS") == "cpu":
    # Read when the CPU backend starts (a no-op if it already has).
    _flag = "--xla_force_host_platform_device_count=8"
    if _flag not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = f"{os.environ.get('XLA_FLAGS', '')} {_flag}"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def _rss_gb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


_LAST_CLEAR_RSS = [0.0]


def pytest_runtest_setup(item):
    """Bound in-process XLA executable accumulation.

    A full-suite run grows to ~7-8 GB RSS of live compiled executables,
    at which point XLA-CPU's backend_compile has been seen to SEGV on the
    next large program (an in-process JIT-code accumulation failure, not
    OOM). Dropping the jit caches when RSS crosses a threshold keeps the
    process in the regime where every compile succeeds; the occasional
    recompile of a shared step costs seconds."""
    rss = _rss_gb()
    if rss > 5.0 and rss - _LAST_CLEAR_RSS[0] > 1.0:
        jax.clear_caches()
        import gc
        gc.collect()
        _LAST_CLEAR_RSS[0] = _rss_gb()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: compiled-kernel checks that need a GPU (skipped elsewhere; "
        "`python chip_smoke.py` runs them on the card)")


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def modelnet_root(tmp_path_factory):
    from adversarial_learning_on_pointclouds.data.modelnet40 import (
        make_synthetic_modelnet_h5,
    )
    root = tmp_path_factory.mktemp("modelnet40")
    return make_synthetic_modelnet_h5(str(root), num_train=48, num_test=16,
                                      num_points=256)


@pytest.fixture(scope="session")
def shapenet_root(tmp_path_factory):
    from adversarial_learning_on_pointclouds.data.shapenet_part import (
        make_synthetic_shapenet,
    )
    root = tmp_path_factory.mktemp("shapenet_part")
    return make_synthetic_shapenet(str(root), num_shapes=48, num_points=256)


@pytest.fixture()
def np_rng():
    return np.random.default_rng(0)
