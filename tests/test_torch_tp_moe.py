"""Tensor parallelism over the model axis for the MoE, MLA and hybrid
decoders, on 2 and 4 gloo ranks on the CPU against the JAX package
(``tests/_torch_tp.py``: the harness and its tolerance, 1e-5 relative).

Mixtral-8x7B (experts' hidden dim split, the router whole and every rank
routing alike, the load-balance loss counted once), DeepSeek-V2-Lite (MLA's
heads split over the whole latent projections and cache, shared experts
split beside the routed ones, a dense first layer) and Jamba-v0.1 (Mamba-2
layers split by head with B and C whole, attention with 2 KV heads held
whole on 4 ranks, MoE every other layer)."""
import pytest

import _torch_tp as H

CASES = [
    ("mixtral", "mixtral-8x7b", {}, False),
    ("deepseek", "deepseek-v2-lite-16b", {}, False),
    ("jamba", "jamba-v0.1-52b", {}, False),
]
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.run_cases(tmp_path_factory, CASES)


@pytest.mark.parametrize("world", H.WORLDS)
@pytest.mark.parametrize("cid", IDS)
def test_loss_and_grads_match_jax(runs, cid, world):
    H.check_loss_and_grads(*runs, cid, world)


@pytest.mark.parametrize("world", H.WORLDS)
@pytest.mark.parametrize("cid", IDS)
def test_forward_prefill_decode_match_jax(runs, cid, world):
    H.check_serving(*runs, cid, world)
