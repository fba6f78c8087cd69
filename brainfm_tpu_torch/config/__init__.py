from .config import AttrDict, load_config, merge_missing, update_out_dir

__all__ = ["AttrDict", "load_config", "merge_missing", "update_out_dir"]
