from .prepare import center_crop, prepare_image, zero_crop_bounds
from .tiles import tile_plan, tiled_apply
from .api import (Inferencer, TwoStageInferencer, default_atlas_path,
                  get_deformed_atlas)

__all__ = ["prepare_image", "center_crop", "zero_crop_bounds", "tile_plan",
           "tiled_apply", "Inferencer", "TwoStageInferencer",
           "default_atlas_path", "get_deformed_atlas"]
