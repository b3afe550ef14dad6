"""Composable update rules — the port's one optimizer API (the reference's
``repro.optim.update_rules`` over dicts of tensors).

An :class:`UpdateRule` is an optax-style gradient transformation::

    state   = rule.init(params)
    updates, state = rule.update(grads, state, params)
    params  = apply_updates(params, updates)

Params, gradients and updates are dicts of tensors (agent-stacked in the
federated core: the leading axis of every leaf is the agent).  A rule's
state nests dicts, tuples (a chain's states) and tensors; the step count is
a 0-dim int32 tensor on the params' device, and a learning-rate schedule is
evaluated from it with torch ops, so no step reads it back to the host.

* **Transformations** — ``trace`` (momentum), ``scale_by_adam``,
  ``clip_by_global_norm``, ``add_decayed_weights``, ``scale``,
  ``scale_by_learning_rate`` (where schedules plug in), composed with
  ``chain``.
* **Aliases** — ``sgd(lr)`` (``(-lr) * g``: with ``apply_updates`` it is
  bit-identical to the inline ``x - lr * g`` step), ``momentum``,
  ``nesterov``, ``adam``, ``adamw``, and the FedOpt server presets
  ``fedavgm`` / ``fedadam``.
* **Declarative layer** — :func:`parse_update_rule`, :func:`make_lr_schedule`
  and :func:`resolve_update_rules`, which build ``Algorithm.bind``'s kwargs
  from the ``ExperimentSpec`` fields.

At communication rounds :func:`comm_opt_state` applies the algorithm's
policy to the agent-stacked buffers: ``"mix"`` moves them through the
round's mixing operator (W_k or J), ``"keep"`` leaves them, ``"reset"``
zeroes them at server rounds; the step count is never mixed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.optim import schedules as S
from repro_torch.utils.pytree import tree_leaves, tree_map

Tree = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """``init/update`` gradient transformation.  ``n_buffers`` counts the
    params-shaped state streams (momentum 1, Adam 2, SGD 0): what the byte
    model prices when the ``"mix"`` policy ships them with the model."""

    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Optional[Tree]], Tuple[Tree, Any]]
    name: str = "rule"
    n_buffers: int = 0


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``params + updates``, accumulated in float32 and cast back."""
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype), params, updates)


def _count0(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


# ---------------------------------------------------------------------------
# Transformations
# ---------------------------------------------------------------------------


def chain(*rules: UpdateRule) -> UpdateRule:
    """Compose transformations left to right; the state is the tuple of states."""

    def init(params):
        return tuple(r.init(params) for r in rules)

    def update(grads, state, params=None):
        new_states = []
        for r, s in zip(rules, state):
            grads, s = r.update(grads, s, params)
            new_states.append(s)
        return grads, tuple(new_states)

    return UpdateRule(init, update, name="|".join(r.name for r in rules),
                      n_buffers=sum(r.n_buffers for r in rules))


def scale(factor: float) -> UpdateRule:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: factor * g, grads), state

    return UpdateRule(init, update, name=f"scale({factor})")


def scale_by_learning_rate(lr: Union[float, Schedule]) -> UpdateRule:
    """``-lr_t * g``, the terminal descent scaling; owns the step count the
    schedule is evaluated at."""

    def init(params):
        return {"count": _count0(params)}

    if callable(lr):
        def update(grads, state, params=None):
            step = lr(state["count"])
            return tree_map(lambda g: -step * g, grads), {"count": state["count"] + 1}
    else:
        # (-lr) * g then p + u is bit-identical to the inline p - lr * g
        neg = -float(lr)

        def update(grads, state, params=None):
            return tree_map(lambda g: neg * g, grads), {"count": state["count"] + 1}

    return UpdateRule(init, update, name="lr")


def trace(decay: float, nesterov: bool = False) -> UpdateRule:
    """Momentum accumulator ``mu = decay * mu + g`` (heavy ball / Nesterov)."""

    def init(params):
        return {"mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        mu = tree_map(lambda m, g: decay * m + g, state["mu"], grads)
        out = tree_map(lambda m, g: decay * m + g, mu, grads) if nesterov else mu
        return out, {"mu": mu}

    return UpdateRule(init, update, name=f"trace({decay})", n_buffers=1)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> UpdateRule:
    """Adam direction: bias-corrected first and second moments (no LR)."""

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"count": _count0(params), "m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params=None):
        count = state["count"] + 1
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.to(torch.float32), state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        c = count.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, c)
        c2 = 1.0 - torch.pow(b2, c)
        out = tree_map(lambda mm, vv: (mm / c1) / (torch.sqrt(vv / c2) + eps), m, v)
        return out, {"count": count, "m": m, "v": v}

    return UpdateRule(init, update, name="adam_dir", n_buffers=2)


def clip_by_global_norm(max_norm: float) -> UpdateRule:
    """Rescale the whole update when its global L2 norm (over every element
    of every leaf, agents included) exceeds ``max_norm``."""

    def init(params):
        return ()

    def update(grads, state, params=None):
        sq = sum(torch.sum(torch.square(g)) for g in tree_leaves(grads))
        factor = torch.clamp(max_norm / torch.clamp_min(torch.sqrt(sq), 1e-16), max=1.0)
        return tree_map(lambda g: factor * g, grads), state

    return UpdateRule(init, update, name=f"clip({max_norm})")


def add_decayed_weights(weight_decay: float) -> UpdateRule:
    def init(params):
        return ()

    def update(grads, state, params=None):
        if not weight_decay or params is None:
            return grads, state
        return tree_map(lambda g, p: g + weight_decay * p.to(torch.float32), grads, params), state

    return UpdateRule(init, update, name=f"wd({weight_decay})")


def _named(rule: UpdateRule, name: str) -> UpdateRule:
    return dataclasses.replace(rule, name=name)


# ---------------------------------------------------------------------------
# Aliases (local rules and the FedOpt server presets)
# ---------------------------------------------------------------------------


def sgd(lr: Union[float, Schedule]) -> UpdateRule:
    """Plain SGD, the default local rule: bit-identical to the inline step."""
    return _named(scale_by_learning_rate(lr), "sgd")


def momentum(lr: Union[float, Schedule], beta: float = 0.9, nesterov: bool = False) -> UpdateRule:
    return _named(chain(trace(beta, nesterov=nesterov), scale_by_learning_rate(lr)),
                  f"{'nesterov' if nesterov else 'momentum'}({beta})")


def adam(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> UpdateRule:
    return _named(chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(lr)), "adam")


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> UpdateRule:
    return _named(chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                        scale_by_learning_rate(lr)), "adamw")


def fedavgm(lr: Union[float, Schedule] = 1.0, beta: float = 0.9) -> UpdateRule:
    """FedAvgM server rule [Hsu et al.]: momentum over round pseudo-gradients."""
    return _named(momentum(lr, beta=beta), f"fedavgm({beta})")


def fedadam(lr: Union[float, Schedule] = 0.1, b1: float = 0.9, b2: float = 0.99,
            eps: float = 1e-3) -> UpdateRule:
    """FedAdam server rule [Reddi et al.] with the FedOpt defaults."""
    return _named(adam(lr, b1=b1, b2=b2, eps=eps), "fedadam")


# ---------------------------------------------------------------------------
# Opt-state plumbing for the federated core
# ---------------------------------------------------------------------------

OPT_POLICIES = ("mix", "keep", "reset")


def map_state(fn: Callable[[torch.Tensor], torch.Tensor], state: Any) -> Any:
    """``fn`` over every tensor of a rule state (dicts, tuples, tensors)."""
    if isinstance(state, dict):
        return {k: map_state(fn, state[k]) for k in sorted(state)}
    if isinstance(state, tuple):
        return tuple(map_state(fn, s) for s in state)
    return fn(state)


def init_opt_state(x0: Tree, local_opt: Optional[UpdateRule] = None,
                   server_opt: Optional[UpdateRule] = None) -> Any:
    """The ``opt`` slot of an algorithm state: ``()`` without rules, else
    ``{"local": agent-stacked local-rule state, "server": server state or
    ()}``.  A server rule alone takes its local state from ``sgd``."""
    if local_opt is None and server_opt is None:
        return ()
    if local_opt is None:
        local_opt = sgd(0.0)
    return {"local": local_opt.init(x0),
            "server": server_opt.init(x0) if server_opt is not None else ()}


def comm_opt_state(opt_state: Any, mix: Callable[[Tree], Tree], n_agents: int, policy: str,
                   *, is_global: bool = False) -> Any:
    """The opt-state communication policy at a communication round: "mix"
    moves every agent-stacked buffer through ``mix`` (W_k on gossip rounds,
    J or S_k on server rounds), "keep" leaves them, "reset" zeroes them at
    server rounds; scalar state (step counts) is never touched."""
    if policy not in OPT_POLICIES:
        raise ValueError(f"opt policy {policy!r} not in {OPT_POLICIES}")
    if policy == "keep" or (isinstance(opt_state, tuple) and opt_state == ()):
        return opt_state

    def stacked(v: torch.Tensor) -> bool:
        return v.dim() >= 1 and v.shape[0] == n_agents

    if policy == "reset":
        if not is_global:
            return opt_state
        return map_state(lambda v: torch.zeros_like(v) if stacked(v) else v, opt_state)
    return map_state(lambda v: mix({"v": v})["v"] if stacked(v) else v, opt_state)


def server_step(server_opt: UpdateRule, server_state: Any, avg_old: Tree,
                avg_new: Tree) -> Tuple[Tree, Any]:
    """One FedOpt server update at a global-averaging round: the server rule
    descends from ``avg_old`` along the pseudo-gradient ``avg_old -
    avg_new`` (both through the server's averaging operator);
    ``sgd(1.0)`` recovers plain averaging up to float association."""
    delta = tree_map(lambda a, b: a - b, avg_old, avg_new)
    upd, server_state = server_opt.update(delta, server_state, avg_old)
    return apply_updates(avg_old, upd), server_state


# ---------------------------------------------------------------------------
# Declarative layer: strings -> rules
# ---------------------------------------------------------------------------

# name -> (constructor, default kwargs overriding the caller's fallback lr)
_RULE_TABLE = {
    "sgd": (sgd, {}),
    "momentum": (momentum, {}),
    "nesterov": (lambda lr, beta=0.9: momentum(lr, beta=beta, nesterov=True), {}),
    "adam": (adam, {}),
    "adamw": (adamw, {}),
    "fedavgm": (fedavgm, {"lr": 1.0}),
    "fedadam": (fedadam, {"lr": 0.1}),
}
# lr-free transformations allowed in non-final chain positions
_TRANSFORM_TABLE = {"clip": (clip_by_global_norm, "max_norm")}

RULE_NAMES = tuple(sorted(_RULE_TABLE)) + tuple(sorted(_TRANSFORM_TABLE))


def _parse_args(argstr: str, positional: Optional[str] = None) -> dict:
    """``"0.9"`` (one positional) or ``"beta=0.9,lr=0.1"`` -> kwargs."""
    out = {}
    for part in filter(None, (s.strip() for s in argstr.split(","))):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = float(v)
        elif positional is not None and positional not in out:
            out[positional] = float(part)
        else:
            raise ValueError(f"positional arg {part!r} needs a k=v form")
    return out


def parse_update_rule(spec: str, *, lr: Union[float, Schedule] = 1.0,
                      force_lr: bool = False) -> UpdateRule:
    """An :class:`UpdateRule` from its string form ``part("|"part)*``, each
    part ``name[:args]``: the last a named rule (sgd, momentum, nesterov,
    adam, adamw, fedavgm, fedadam), earlier ones lr-free transforms
    (``clip:<max_norm>``).  ``lr`` is the caller's fallback, overridden by
    a preset's default (fedadam 0.1) or an explicit ``lr=`` — unless
    ``force_lr``, which makes the caller's win (an active schedule)."""
    parts = [p.strip() for p in spec.split("|") if p.strip()]
    if not parts:
        raise ValueError(f"empty update-rule spec {spec!r}")
    rules = []
    for i, part in enumerate(parts):
        name, _, argstr = part.partition(":")
        name = name.strip()
        last = i == len(parts) - 1
        if name in _TRANSFORM_TABLE:
            if last:
                raise ValueError(
                    f"{name!r} is a transform and cannot terminate the chain "
                    f"{spec!r}; end with one of {sorted(_RULE_TABLE)}"
                )
            ctor, positional = _TRANSFORM_TABLE[name]
            rules.append(ctor(**_parse_args(argstr, positional)))
        elif name in _RULE_TABLE:
            if not last:
                raise ValueError(f"rule {name!r} must be the final part of {spec!r}")
            ctor, defaults = _RULE_TABLE[name]
            kw = dict(defaults)
            kw.update(_parse_args(argstr, "lr"))
            if force_lr:
                kw["lr"] = lr
            else:
                kw.setdefault("lr", lr)
            rules.append(ctor(**kw))
        else:
            raise ValueError(f"unknown update rule {name!r}; options: {RULE_NAMES}")
    rule = rules[0] if len(rules) == 1 else chain(*rules)
    return _named(rule, spec)


def _explicit_lr(spec: str) -> Optional[float]:
    """The ``lr`` the rule string pins (an explicit ``lr=`` or positional on
    the final part, or a preset's default), if any."""
    last = spec.split("|")[-1].strip()
    name, _, argstr = last.partition(":")
    entry = _RULE_TABLE.get(name.strip())
    args = dict(entry[1]) if entry else {}
    try:
        args.update(_parse_args(argstr, "lr"))
    except ValueError:
        return None  # parse_update_rule raises the real error
    return args.get("lr")


_SCHEDULE_NAMES = ("constant", "linear", "cosine", "warmup_cosine")


def make_lr_schedule(spec: Optional[str], base_lr: float,
                     total_steps: int) -> Union[float, Schedule]:
    """Per-step local-LR decay, ``name[:k=v,...]`` over :mod:`.schedules`,
    evaluated at the rule's step count (``rounds * (T_o + 1)`` steps in
    all); ``None`` / ``"constant"`` return the plain float."""
    if spec is None:
        return base_lr
    name, _, argstr = spec.partition(":")
    name = name.strip()
    if name == "constant":
        return base_lr
    args = _parse_args(argstr, "final")
    if name == "linear":
        return S.linear_decay(base_lr, total_steps, final=args.get("final", 0.0))
    if name == "cosine":
        return S.cosine_decay(base_lr, total_steps, final=args.get("final", 0.0))
    if name == "warmup_cosine":
        warmup = int(args.get("warmup", 0.1) * total_steps)
        return S.warmup_cosine(base_lr, warmup, total_steps, final=args.get("final", 0.0))
    raise ValueError(f"unknown lr schedule {name!r}; options: {_SCHEDULE_NAMES}")


def resolve_update_rules(
    optimizer: Optional[str] = None,
    server_optimizer: Optional[str] = None,
    lr_schedule: Optional[str] = None,
    opt_policy: Optional[str] = None,
    *,
    eta_l: float,
    rounds: int,
    t_o: int,
) -> dict:
    """``Algorithm.bind`` kwargs from the spec's optimizer fields; ``{}``
    when all are unset (the inline hardcoded-SGD path)."""
    kw = {}
    if optimizer is not None or lr_schedule is not None:
        # an explicit lr= in the rule string is the schedule's base
        base = eta_l
        if optimizer is not None:
            explicit = _explicit_lr(optimizer)
            if explicit is not None:
                base = explicit
        lr = make_lr_schedule(lr_schedule, base, rounds * (t_o + 1))
        kw["local_opt"] = parse_update_rule(optimizer or "sgd", lr=lr,
                                            force_lr=lr_schedule is not None)
    if server_optimizer is not None:
        kw["server_opt"] = parse_update_rule(server_optimizer, lr=1.0)
    if opt_policy is not None:
        if opt_policy not in OPT_POLICIES:
            raise ValueError(f"opt policy {opt_policy!r} not in {OPT_POLICIES}")
        kw["opt_policy"] = opt_policy
    return kw
