"""The launcher's checkpoints hold the state of every algorithm it binds,
with and without update rules, in the reference's leaf order, key paths,
shapes and dtypes (``repro_torch.launch.train.nested_state``), and pour back
into a fresh state unchanged (``restore_into``): what lets either package's
launcher restore the other's files (the runs themselves are in
``test_torch_launch_train.py``)."""
import json
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402

from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.core.algorithms import get_algorithm as j_get_algorithm  # noqa: E402
from repro.core.algorithms import registered_algorithms as j_algorithms  # noqa: E402
from repro.core.mixing import dense_mixing as j_dense_mixing  # noqa: E402
from repro.core.pisco import PiscoConfig as JPiscoConfig  # noqa: E402
from repro.core.pisco import replicate_params as j_replicate  # noqa: E402
from repro.core.topology import make_topology as j_make_topology  # noqa: E402
from repro.models import get_bundle as j_get_bundle  # noqa: E402
from repro.optim.update_rules import resolve_update_rules as j_rules  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import PiscoConfig, dense_mixing, make_topology  # noqa: E402
from repro_torch.core.algorithms import get_algorithm, registered_algorithms  # noqa: E402
from repro_torch.core.pisco import replicate_params  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.models.transformer import params_from_paths  # noqa: E402
from repro_torch.optim import resolve_update_rules  # noqa: E402
from repro_torch.utils.pytree import flatten_paths  # noqa: E402

ARCH = "qwen3-8b"


def _strip(key: str) -> str:
    """A checkpoint key without its ``d:``/``a:``/``s:`` markers (a flat
    dict key holds several path parts)."""
    return re.sub(r"(^|/)[das]:", r"\1", key)


def _jax_keys(tree) -> list:
    def name(k):
        return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))

    return ["/".join(name(k) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("rules", [False, True], ids=["no-rules", "rules"])
@pytest.mark.parametrize("algo", sorted(registered_algorithms()))
def test_state_leaves_in_the_reference_order(algo, rules, tmp_path):
    """Every algorithm the CLI binds, with and without update rules: the
    checkpoint of the port's state lists the reference state's leaves in
    its order, path, shape and dtype."""
    assert sorted(j_algorithms()) == sorted(registered_algorithms())
    n, seq = 4, 8
    cfg, jcfg = get_reduced(ARCH), j_get_reduced(ARCH)
    bundle, jbundle = get_bundle(cfg, "cpu"), j_get_bundle(jcfg)
    spec = ("momentum", "fedadam", "cosine") if rules else (None, None, None)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(n, 1, seq),
                                               dtype=np.int32)

    params = flatten_paths(bundle.init(0))
    state = get_algorithm(algo).bind(
        lambda f, b: bundle.loss(params_from_paths(f, cfg), b),
        PiscoConfig(n, 1, 0.05, 1.0, 0.1), dense_mixing(make_topology("ring", n), "cpu"),
        **resolve_update_rules(*spec, eta_l=0.05, rounds=6, t_o=1),
    ).init(lambda f, b: bundle.loss(params_from_paths(f, cfg), b),
           replicate_params(params, n), {"tokens": torch.from_numpy(tokens)})
    jparams = jbundle.init(jax.random.PRNGKey(0))
    jstate = j_get_algorithm(algo).bind(
        jbundle.loss, JPiscoConfig(n, 1, 0.05, 1.0, 0.1),
        j_dense_mixing(j_make_topology("ring", n)),
        **j_rules(*spec, eta_l=0.05, rounds=6, t_o=1),
    ).init(jbundle.loss, j_replicate(jparams, n), {"tokens": jax.numpy.asarray(tokens)})

    path = save_checkpoint(str(tmp_path), 0, ttrain.nested_state(state, cfg))
    with np.load(path) as data:
        manifest = json.loads(bytes(data["__manifest__"].tobytes()).decode())
    _, jtree = j_restore(path)
    jleaves = jax.tree_util.tree_leaves(jstate)
    assert [_strip(k) for k in manifest["keys"]] == _jax_keys(jstate)
    assert [(tuple(a.shape), str(a.dtype)) for a in jax.tree_util.tree_leaves(jtree)] == [
        (tuple(a.shape), str(a.dtype)) for a in jleaves]
    # and the leaves pour back into a fresh port state unchanged
    _, tree = restore_checkpoint(path)
    back = ttrain.restore_into(state, tree, cfg)
    for a, b in zip(ttrain._leaves(back), ttrain._leaves(state)):
        assert torch.equal(a, b)
