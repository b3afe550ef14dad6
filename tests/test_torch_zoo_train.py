"""Training through the MoE, MLA and hybrid stacks: ``lm_loss`` (cross-
entropy plus the MoE load-balance loss) and its gradients for the reduced
Mixtral-8x7B, DeepSeek-V2-Lite and Jamba-v0.1 against
``jax.value_and_grad`` of the reference's ``lm_loss`` on the same numpy
tokens, in ``tests/test_torch_lm_train.py``'s pattern (its helpers and
tolerance), with activation checkpointing, chunked cross-entropy and chunked
causal attention among the cases."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
from test_torch_lm_train import GRAD_TOL, _np, _pair  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.utils.pytree import nest_leaves  # noqa: E402


@pytest.mark.parametrize("arch,replace", [
    ("mixtral-8x7b", {}),                                         # the window (32) inside S 48
    ("mixtral-8x7b", {"remat": True, "attn_chunk": 16, "loss_chunk": 20}),
    ("deepseek-v2-lite-16b", {}),                                 # MLA + dense head layer
    ("deepseek-v2-lite-16b", {"remat": True, "attn_chunk": 16}),
    ("jamba-v0.1-52b", {}),
    ("jamba-v0.1-52b", {"remat": True, "loss_chunk": 24}),
])
def test_lm_loss_and_grads_match_jax(arch, replace):
    jcfg, cfg, jparams, params = _pair(arch, **replace)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 48)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(lambda p: JT.lm_loss(p, jcfg, {"tokens": toks}))(jparams)
    loss, grads = get_bundle(cfg, "cpu").value_and_grad(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=GRAD_TOL)
    jl, tl = jax.tree.leaves(jax.tree.map(np.asarray, jgrads)), nest_leaves(grads)
    assert len(jl) == len(tl) == len(nest_leaves(params))
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
        scale = float(np.abs(a).max())
        assert float(np.abs(_np(b) - a).max()) <= GRAD_TOL * scale
    assert not any(t.requires_grad for t in tl + nest_leaves(params))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b", "jamba-v0.1-52b"])
def test_moe_aux_loss_is_in_the_loss(arch):
    """lm_loss = the cross-entropy of lm_forward's logits + its MoE aux loss,
    and the aux loss is the reference's."""
    jcfg, cfg, jparams, params = _pair(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    logits, aux = TT.lm_forward(params, cfg, torch.from_numpy(toks))
    _, jaux = JT.lm_forward(jparams, jcfg, toks)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    pred = logits[:, :-1].float()
    ce = torch.mean(torch.logsumexp(pred, -1) - torch.gather(
        pred, -1, torch.from_numpy(toks[:, 1:]).long()[..., None])[..., 0])
    np.testing.assert_allclose(float(TT.lm_loss(params, cfg, {"tokens": torch.from_numpy(toks)})),
                               float(ce + aux), rtol=1e-6)
