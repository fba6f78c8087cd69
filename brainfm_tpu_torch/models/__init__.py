from .build import (Joiner, apply_processors, build_backbone, build_model,
                    postprocess, process_args)
from .heads import ConvBlock, TaskHead
from .params_io import from_jax_params, load_pth
from .unet3d import UNet3D, feature_maps

__all__ = ["Joiner", "apply_processors", "build_backbone", "build_model",
           "postprocess", "process_args", "ConvBlock", "TaskHead",
           "from_jax_params", "load_pth",
           "UNet3D", "feature_maps"]
