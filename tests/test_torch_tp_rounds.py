"""Flat PISCO rounds with the model axis (mesh data 2 x model 2): two agents
of two model ranks each on the reduced Mamba2-370m, a gossip, a server and a
q8d gossip round with error feedback against the reference's round on the
stacked agents, and the q8d probe (``tests/_torch_tp_rounds.py``: the harness
and its tolerances)."""
import pytest

import _torch_tp_rounds as H


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.run_modes(tmp_path_factory, ["flat"])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_round_matches_the_reference(runs, k):
    H.check_round(runs, "flat", k)


def test_q8d_on_shards_scales_by_the_whole_leaf(runs):
    H.check_q8d_probe(runs)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_whole_leaves_bit_identical_across_model_ranks(runs, k):
    H.check_whole_leaves_identical(runs, "flat", k)


def test_notes_record_the_model_axis(runs):
    notes = H.notes_of(runs, "flat")
    assert notes["model_axis"] == 2 and notes["agent_axes"] == ["data"]
    assert notes["n_agents"] == 2
    assert notes["layout_differs"] == ["layers/pos0/mixer/conv_b", "layers/pos0/mixer/conv_w",
                                       "layers/pos0/mixer/in_proj"]
