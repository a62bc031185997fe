"""Logical-axis sharding rules (the reference's ``sharding/``)."""
from repro_torch.sharding.specs import (P, Rules, active, constrain,
                                        data_only_rules, make_rules,
                                        use_rules)

__all__ = ["P", "Rules", "active", "constrain", "data_only_rules",
           "make_rules", "use_rules"]
