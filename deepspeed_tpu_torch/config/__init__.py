from .config import DeepSpeedTPUConfig, PrefixCacheConfig, parse_config

__all__ = ["DeepSpeedTPUConfig", "PrefixCacheConfig", "parse_config"]
