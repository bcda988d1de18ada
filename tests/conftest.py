"""Test configuration: run JAX on a virtual 8-device CPU mesh so all
sharding/collective logic is exercised without an accelerator
(SURVEY.md §4c).  The platform is also set through jax.config, which
still applies when a pytest plugin imported jax before this file ran;
tests that need a GPU carry the ``gpu`` marker."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
