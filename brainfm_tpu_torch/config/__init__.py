from .config import AttrDict, load_config, merge_missing

__all__ = ["AttrDict", "load_config", "merge_missing"]
