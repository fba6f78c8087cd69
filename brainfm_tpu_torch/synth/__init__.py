from .constants import (CT_BRIGHTNESS_GROUP, LABELS_EXTRACEREBRAL,
                        LABELS_LEFT, N_NEUTRAL, build_lut, build_vflip)
from .deform import (deform_grid, make_affine_matrix, random_affine,
                     random_nonlinear_field)
from .draws import Draws
from .engine import (SubjectBank, build_knobs_stack, knobs_from_cfg,
                     synth_item)
from .gmm import build_contrast_lut, sample_contrast_lut
from .params import SynthStatic, resolution_sampler, sample_setup

__all__ = [
    "CT_BRIGHTNESS_GROUP", "LABELS_EXTRACEREBRAL", "LABELS_LEFT", "N_NEUTRAL",
    "build_lut", "build_vflip", "deform_grid",
    "make_affine_matrix", "random_affine", "random_nonlinear_field", "Draws",
    "SubjectBank", "build_knobs_stack", "knobs_from_cfg", "synth_item",
    "build_contrast_lut", "sample_contrast_lut", "SynthStatic",
    "resolution_sampler", "sample_setup",
]
