"""Device-mesh helpers.

The framework's only communication abstraction is jax.sharding (SURVEY §5.8):
XLA emits the collectives over the device interconnect; multi-host
scale-out goes through jax.distributed.  The reference has no distributed
backend at all — these axes exist to scale rendering past one device.

Axes:
  "data"  — independent clips / parameter-sweep points (embarrassingly
            parallel; the primary axis),
  "block" — sample blocks of one long clip (overlap-add halo exchange via
            ppermute; the audio analog of context/sequence parallelism).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
BLOCK_AXIS = "block"


def make_mesh(
    data: Optional[int] = None,
    block: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("data", "block") mesh over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        data = n // block
    if data * block != n:
        raise ValueError(f"mesh {data}x{block} != {n} devices")
    dev_array = np.asarray(devices).reshape(data, block)
    return Mesh(dev_array, (DATA_AXIS, BLOCK_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading batch axis over "data", replicate the rest."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(**kwargs) -> None:
    """Multi-host entry: jax.distributed.initialize passthrough (DCN scale-out)."""
    jax.distributed.initialize(**kwargs)
