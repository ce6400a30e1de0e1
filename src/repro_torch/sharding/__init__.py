from .rules import default_rules, spec_for, sharding_tree, replicated_tree
from .context import activation_sharding, constrain, active

__all__ = [
    "default_rules", "spec_for", "sharding_tree", "replicated_tree",
    "activation_sharding", "constrain", "active",
]
