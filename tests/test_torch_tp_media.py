"""Tensor parallelism over the model axis for Mamba2-370m, the
encoder-decoder (SeamlessM4T-medium) and the VLM (Qwen2-VL-2B), on 2 and 4
gloo ranks on the CPU against the JAX package (``tests/_torch_tp.py``: the
harness and its tolerance, 1e-5 relative).

Mamba2-370m: split by head (z, x and dt by head, B and C whole, the gated
RMSNorm's sum of squares summed over the ranks), its tied vocabulary split;
also under remat "dots".  Seamless: the encoder's non-causal attention and
the decoder's self- and cross-attention on the rank's heads.  Qwen2-VL: a
prefix of patch embeddings before the tokens, M-RoPE's text ids."""
import pytest

import _torch_tp as H

CASES = [
    ("mamba2", "mamba2-370m", {}, False),
    ("mamba2_dots", "mamba2-370m", {"remat": True, "remat_policy": "dots"}, False),
    ("seamless", "seamless-m4t-medium", {}, False),
    ("qwen2vl", "qwen2-vl-2b", {}, True),
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
