"""Test configuration.

By default the tests run on the CPU with 8 virtual devices, so the
sharding tests get a mesh without accelerator hardware (SURVEY.md §4 item
5: JAX's standard multi-host test story); ``gpu``-marked tests skip.

``SMCSMC_GPU_TESTS=1`` (``make gpu-tests``, ``chip_smoke.py``) keeps the
real GPU backend instead and runs only the ``gpu``-marked device tier."""

import os

GPU_TIER = bool(os.environ.get("SMCSMC_GPU_TESTS"))

if GPU_TIER:
    from smcsmc_tpu._cache import enable_compilation_cache

    enable_compilation_cache()
else:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)


def pytest_collection_modifyitems(config, items):
    """In the device tier, run ONLY gpu-marked tests; in the CPU tiers,
    skip them.  The choice rests on the environment alone, never on which
    devices exist, so every test worker collects the same tests."""
    import pytest

    for item in items:
        is_gpu = "gpu" in item.keywords
        if GPU_TIER and not is_gpu:
            item.add_marker(
                pytest.mark.skip(reason="device tier runs only gpu tests")
            )
        elif not GPU_TIER and is_gpu:
            item.add_marker(
                pytest.mark.skip(
                    reason="needs a GPU and SMCSMC_GPU_TESTS=1 "
                    "(make gpu-tests)"
                )
            )
