from repro_torch.utils.pytree import (
    tree_add,
    tree_agent_mean,
    tree_agent_mix,
    tree_axpy,
    tree_bytes,
    tree_dot,
    tree_scale,
    tree_size,
    tree_sq_norm,
    tree_stack,
    tree_sub,
    tree_unstack,
    tree_zeros_like,
)

__all__ = [
    "tree_stack", "tree_unstack", "tree_zeros_like", "tree_add", "tree_sub", "tree_scale",
    "tree_axpy", "tree_dot", "tree_sq_norm", "tree_agent_mean", "tree_agent_mix", "tree_size",
    "tree_bytes",
]
