"""Pod-as-agent with the model axis (mesh pod 1 x data 2 x model 2): one agent
over two data ranks of two model ranks each, each rank holding the data
shard of its model shard of x, y and g, on the reduced Qwen3-8B widened to
d_model 1,024; gossip, server, gossip against the reference's round
(``tests/_torch_tp_rounds.py``: the harness and its tolerance)."""
import pytest

import _torch_tp_rounds as H


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.run_modes(tmp_path_factory, ["hier"])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_round_matches_the_reference(runs, k):
    H.check_round(runs, "hier", k)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_whole_leaves_bit_identical_across_model_ranks(runs, k):
    H.check_whole_leaves_identical(runs, "hier", k)


def test_notes_record_the_model_axis(runs):
    notes = H.notes_of(runs, "hier")
    assert notes["model_axis"] == 2 and notes["agent_axes"] == ["pod"]
    assert not notes["layout_differs"]
