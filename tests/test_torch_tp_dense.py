"""Tensor parallelism over the model axis (``repro_torch.launch.mesh.ModelAxis``)
for the dense decoders, on 2 and 4 gloo ranks on the CPU against the JAX
package's ``lm_loss`` gradients, ``lm_forward``, prefill and decode
(``tests/_torch_tp.py``: the harness and its tolerance, 1e-5 relative).

The cases cover: heads and KV heads split (Qwen3-8B, Qwen2.5-14B with its
QKV bias, Nemotron-4 with squared ReLU); KV heads held whole where the
model ranks outnumber them (2 KV heads on 4 ranks: every rank projects both
and attends with its q heads' one); Granite's multi-query attention (one KV
head, held whole on every rank, its gradient summed over the ranks); a
vocabulary that stays whole (514 on 4 ranks; split on 2); and both remat
policies, whose recomputation reruns the collectives in the same order on
every rank (the ranks' logs of collectives are equal, and remat adds the
recomputed forward's all-reduces to the gradient call's)."""
import pytest

import _torch_tp as H

CASES = [
    ("qwen3", "qwen3-8b", {}, False),
    ("qwen25", "qwen2.5-14b", {}, False),
    ("granite", "granite-20b", {}, False),
    ("nemotron", "nemotron-4-340b", {}, False),
    ("vocab514", "qwen3-8b", {"vocab_size": 514}, False),
    ("remat_full", "qwen3-8b", {"remat": True, "remat_policy": "full"}, False),
    ("remat_dots", "qwen3-8b", {"remat": True, "remat_policy": "dots"}, False),
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


@pytest.mark.parametrize("world", H.WORLDS)
def test_vocab_split_only_where_it_divides(runs, world):
    """514 splits over 2 ranks and not over 4: the gathered logits are the
    reference's either way, and only the split vocabulary gathers them or
    reduces a max."""
    counts = H.collective_counts(runs[0], "vocab514", world)
    assert (counts["all_reduce_max"] > 0) == (world == 2)
    assert H.collective_counts(runs[0], "qwen3", world)["all_reduce_max"] > 0


@pytest.mark.parametrize("world", H.WORLDS)
def test_remat_reruns_the_collectives(runs, world):
    plain = H.collective_counts(runs[0], "qwen3", world)["all_reduce_sum"]
    for cid in ("remat_full", "remat_dots"):
        assert H.collective_counts(runs[0], cid, world)["all_reduce_sum"] > plain
