import os

# Tests run the JAX engine on a virtual 8-device CPU mesh, so that
# multi-device sharding is exercised without accelerators. The platform
# is pinned both through the environment and through jax.config, since
# the environment may name another default platform.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
