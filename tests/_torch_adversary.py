"""The reference's collusion direction, to put in place of the port's draw
(``AdversaryProcess.collusion_direction``): with it, the port's collusion is
the reference's up to the order of the fleet mean's sum."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import adversary as jadv


def ref_collusion_direction(self, i, shape):
    """The reference's unit direction of leaf i (its JAX PRNG draw), as a
    float32 CPU tensor."""
    base_key = jax.random.fold_in(jax.random.PRNGKey(int(self.seed) & 0x7FFFFFFF), jadv._ADV_TAG)
    d = jax.random.normal(jax.random.fold_in(base_key, i), tuple(shape), jnp.float32)
    d = d / jnp.maximum(jnp.linalg.norm(d.reshape(-1)), jnp.float32(1e-12))
    return torch.from_numpy(np.array(d))
