"""veles_tpu_torch.forge: the model hub (reference ``veles/forge/``).

The port's copy of ``veles_tpu/forge/``: model packages (tar.gz +
``manifest.json`` naming the workflow and config entry files) are
published to and fetched from a forge server. ``package.py`` holds the
format (byte for byte the JAX package's, so either side reads the
other's packages and stores), ``server.py`` and ``client.py`` the two
sides, and ``python -m veles_tpu_torch forge --help`` the CLI. All of it
runs on the host."""

from veles_tpu_torch.forge.client import ForgeClient  # noqa: F401
from veles_tpu_torch.forge.package import (  # noqa: F401
    pack, read_manifest, unpack)
from veles_tpu_torch.forge.server import ForgeServer  # noqa: F401
