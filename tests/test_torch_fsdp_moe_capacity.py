"""Pod-as-agent's MoE capacity over the agent's whole batch
(``repro_torch.models.moe.agent_keep``, ``_agent_capacity``), held against
the reference's rule: the agent's (token, expert) entries stably sorted by
expert, each expert keeping its first ``capacity(T_agent)`` of them.

Data rank r holds the r-th block of the agent's rows, so its entries follow
those of ranks 0 … r-1 in the agent's stream.  The keep rule is held, entry
by entry, against numpy's stable argsort of that stream, through the
port's dispatch (``dispatch_batched`` given each rank's ``keep``): 1, 2 and
4 ranks, balanced and skewed routes, one token a rank.  Whole MoE layers on
the data ranks (``moe_forward`` under a ``DataAxis``) are held against the
reference's ``repro.models.moe.moe_forward`` on the agent's whole batch:
outputs within 1e-5, the load-balance loss within 1e-6, and per-rank
capacity would have kept a different set.  The data ranks run one after
another over a mesh that replays the collectives (:class:`_Replay`); where
the agent's batch does not split, every rank holds it whole and the layer
runs no collective.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import DataAxis, MeshClock  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

from _torch_fsdp import reference_kept  # noqa: E402
from test_torch_moe import LM_ATOL, _assert_routes_equal, _cfgs, _params, _x  # noqa: E402


def _routes(rng, t: int, e: int, k: int, weights) -> np.ndarray:
    """(t, k) distinct experts a token, drawn with ``weights``."""
    p = np.asarray(weights, np.float64) / np.sum(weights)
    return np.stack([rng.choice(e, size=k, replace=False, p=p) for _ in range(t)])


RULE_CASES = {  # n data ranks, T_rank tokens a rank, expert weights
    "1-rank": (1, 24, [1] * 6),
    "2-ranks": (2, 24, [1] * 6),
    "4-ranks": (4, 12, [1] * 6),
    "4-ranks-skewed": (4, 16, [8, 4, 1, 1, 1, 1]),
    "one-token-a-rank": (4, 1, [1] * 6),
}


@pytest.mark.parametrize("name", list(RULE_CASES))
def test_keep_rule_is_the_stable_sort_of_the_agent_s_stream(name):
    n, t, weights = RULE_CASES[name]
    jcfg, cfg = _cfgs(n_experts=6, top_k=2, capacity_factor=1.0)
    mo = cfg.moe
    _, params = _params(jcfg, seed=3)
    experts = {m: params[m] for m in ("w_gate", "w_up", "w_down")}
    rng = np.random.default_rng(sum(map(ord, name)))
    routes = _routes(rng, n * t, mo.n_experts, mo.top_k, weights)  # the agent's (T_agent, k)
    cap_agent = TM.capacity(mo, n * t)
    want = reference_kept(routes.reshape(-1), mo.n_experts, cap_agent).reshape(n, t, mo.top_k)
    counts = torch.stack([torch.from_numpy(np.bincount(routes[r * t:(r + 1) * t].ravel(),
                                                       minlength=mo.n_experts))
                          for r in range(n)])
    differ = 0
    for r in range(n):
        keep = TM.agent_keep(counts, cap_agent, r)
        c = int(keep.max())
        assert c <= min(cap_agent, t * mo.top_k)
        top_idx = torch.from_numpy(routes[r * t:(r + 1) * t])
        top_w = torch.from_numpy(rng.uniform(0.5, 1.0, size=(t, mo.top_k)).astype(np.float32))
        xf = torch.from_numpy(_x(40 + r, (t, cfg.d_model)))
        out = TM.dispatch_batched(experts, cfg, xf, top_idx, top_w, keep=keep, cap=c)
        kept = (out != 0).any(-1).numpy()
        np.testing.assert_array_equal(kept, want[r], err_msg=f"rank {r}")
        own = reference_kept(routes[r * t:(r + 1) * t].reshape(-1), mo.n_experts,
                             TM.capacity(mo, t))
        differ += int(np.sum(own != want[r].reshape(-1)))
    assert want.sum() < want.size, "no expert overflows"
    if n > 1:  # per-rank capacity keeps another set
        assert differ > 0


class _Replay:
    """A data axis of ``n`` ranks run one after another: in the first pass
    each rank's collectives record what it sends (returning its own as
    every rank's), in the second they return what the real ones would
    (the stack or the sum over the ranks, rank 0 first)."""

    def __init__(self, n: int):
        self.n, self.sent, self.second = n, {}, False

    def rank(self, r: int) -> "_ReplayRank":
        return _ReplayRank(self, r)


class _ReplayRank:
    def __init__(self, replay: _Replay, r: int):
        self.replay, self.r, self.calls = replay, r, 0
        self.shape, self.coords = {"data": replay.n}, {"data": r}
        self.clock, self.device = MeshClock(), torch.device("cpu")

    def _call(self, x, combine):
        i, self.calls = self.calls, self.calls + 1
        if not self.replay.second:
            self.replay.sent.setdefault(i, {})[self.r] = x.detach().clone()
            return combine([x.detach()] * self.replay.n)
        return combine([self.replay.sent[i][q] for q in range(self.replay.n)])

    def all_gather(self, x, axes, host=False):
        assert tuple(axes) == ("data",)
        return self._call(x, torch.stack)

    def all_reduce_sum(self, x, axes):
        assert tuple(axes) == ("data",)
        return self._call(x, lambda xs: sum(xs[1:], xs[0].clone()))


class _NoCollectives:
    shape, coords = {"data": 2}, {"data": 0}
    clock, device = MeshClock(), torch.device("cpu")

    def __getattr__(self, name):
        raise AssertionError(f"collective {name} over an unsplit batch")


LAYER_CASES = {  # n data ranks, rows of the agent's batch, tokens a row, gate
    "2-ranks": (2, 2, 24, "softmax_topk"),
    "4-ranks": (4, 4, 12, "topk_softmax"),
    "one-token-a-rank": (4, 4, 1, "topk_softmax"),
    "1-rank": (1, 2, 24, "softmax_topk"),
}


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_on_data_ranks_is_the_reference_on_the_agent_s_batch(name, monkeypatch):
    n, rows, seq, gate = LAYER_CASES[name]
    jcfg, cfg = _cfgs(n_experts=6, top_k=2, capacity_factor=1.0, gate_mode=gate, n_shared=1)
    jp, params = _params(jcfg, seed=4)
    x = _x(50 + n + seq, (rows, seq, cfg.d_model))
    jy, jaux = JM.moe_forward(jp, jcfg, jnp.asarray(x))
    routes = []
    real = TM.route
    monkeypatch.setattr(TM, "route", lambda lg, mo: routes.append((lg, real(lg, mo))) or
                        routes[-1][1])
    replay = _Replay(n)
    blocks = np.split(x, n)
    for second in (False, True):
        replay.second = second
        routes.clear()
        outs = [TM.moe_forward(params, cfg, torch.from_numpy(b),
                               fsdp=DataAxis(replay.rank(r), {}))
                for r, b in enumerate(blocks)]
    logits = np.concatenate([lg.numpy() for lg, _ in routes])
    idx = np.concatenate([rt[0].numpy() for _, rt in routes])
    _assert_routes_equal(JM._route(jnp.asarray(logits), jcfg.moe)[0], idx, logits, 2, name)
    np.testing.assert_allclose(np.concatenate([y.numpy() for y, _ in outs]), np.asarray(jy),
                               atol=LM_ATOL, rtol=0)
    for _, aux in outs:
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    mo, t = cfg.moe, rows * seq // n
    agent = reference_kept(idx.reshape(-1), mo.n_experts, TM.capacity(mo, n * t))
    own = np.concatenate([reference_kept(b.reshape(-1), mo.n_experts, TM.capacity(mo, t))
                          for b in np.split(idx, n)])
    assert agent.sum() < agent.size, "no expert overflows"
    if n > 1:
        assert int(np.sum(own != agent)) > 0


def test_unsplit_batch_routes_whole_with_no_collective():
    """Where the agent's batch does not divide over the data ranks every
    rank holds it whole (``batch_splits`` says so): the layer is the whole
    batch's, bit for bit, and counts no copy twice."""
    jcfg, cfg = _cfgs(n_experts=6, top_k=2, capacity_factor=1.0, gate_mode="topk_softmax",
                      n_shared=1)
    jp, params = _params(jcfg, seed=5)
    x = torch.from_numpy(_x(61, (3, 8, cfg.d_model)))
    mesh = _NoCollectives()
    assert not S.batch_splits({"tokens": x[..., 0]}, {"tokens": 0}, mesh)
    assert S.batch_splits({"tokens": x[:2, :, 0]}, {"tokens": 0}, mesh)
    axis = DataAxis(mesh, {}, split_batch=False)
    y, aux = TM.moe_forward(params, cfg, x, fsdp=axis)
    want_y, want_aux = TM.moe_forward(params, cfg, x)
    assert torch.equal(y, want_y) and torch.equal(aux, want_aux)
    assert axis.stats == {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    jy, jaux = JM.moe_forward(jp, jcfg, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=LM_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
