from .config import PrefixCacheConfig

__all__ = ["PrefixCacheConfig"]
