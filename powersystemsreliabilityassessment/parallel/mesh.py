"""Device mesh helpers: the scenario axis IS the data-parallel axis.

The reference's entire parallelism story is MATLAB ``parfor`` over sampled
states (nsqMain.m:257, seqMain.m:112). The equivalent here is a 1-D
``jax.sharding.Mesh`` over all devices with scenarios sharded along it;
index accumulation crosses the mesh as O(#indices) ``psum``s per batch
(SURVEY.md §5.8). There is no TP/PP/SP/EP analog in this domain — scenarios
are i.i.d. — so the mesh is deliberately one-dimensional.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SCENARIO_AXIS = "scenarios"


def scenario_mesh(devices=None) -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (SCENARIO_AXIS,))


def device_keys(key: jax.Array, n_dev: int) -> jax.Array:
    """[n_dev] per-device keys ``fold_in(key, d)``: device d of a
    scenario mesh draws its batch from ``device_keys(key, n)[d]``, so
    the same batch can be replayed on one device (``step.from_keys``)."""
    return jax.vmap(lambda d: jax.random.fold_in(key, d))(
        np.arange(n_dev, dtype=np.uint32))


def shard_batch(mesh: Mesh, tree):
    """Place a batch pytree with its leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(SCENARIO_AXIS))
    return jax.device_put(tree, sharding)


def replicated(mesh: Mesh, tree):
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)
