from .config import (
    DeepSpeedTPUConfig,
    PrefixCacheConfig,
    PressureConfig,
    ServingSchedulerConfig,
    parse_config,
)

__all__ = ["DeepSpeedTPUConfig", "PrefixCacheConfig", "PressureConfig",
           "ServingSchedulerConfig", "parse_config"]
