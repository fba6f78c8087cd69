from .config import (AttrDict, load_config, merge_missing, preprocess_cfg,
                     to_namespace, update_out_dir)

__all__ = ["AttrDict", "load_config", "merge_missing", "preprocess_cfg",
           "to_namespace", "update_out_dir"]
