from .engine import Config, instantiate, load_config, parse_overrides, to_dict
from .factories import complete_agent_cfg, create_agent, create_one_dim_tr_model

__all__ = [
    "Config",
    "load_config",
    "parse_overrides",
    "instantiate",
    "to_dict",
    "complete_agent_cfg",
    "create_one_dim_tr_model",
    "create_agent",
]
