from .augment import (add_noise, gamma_transform, resample_resolution,
                      sample_bias_field)
from .constants import (CT_BRIGHTNESS_GROUP, LABELS_EXTRACEREBRAL,
                        LABELS_LEFT, N_NEUTRAL, RIGHT_TO_LEFT, build_lut,
                        build_vflip)
from .deform import (deform_grid, integrate_svf, make_affine_matrix,
                     random_affine, random_nonlinear_field)
from .draws import Draws
from .engine import (SubjectBank, build_knobs_stack, knobs_from_cfg,
                     synth_item)
from .gmm import build_contrast_lut, sample_contrast_lut, synth_intensities
from .params import SynthStatic, resolution_sampler, sample_setup
from .pathology import augment_pathology, encode_pathology, random_shape

__all__ = [
    "add_noise", "gamma_transform", "resample_resolution",
    "sample_bias_field", "CT_BRIGHTNESS_GROUP", "LABELS_EXTRACEREBRAL",
    "LABELS_LEFT", "N_NEUTRAL", "RIGHT_TO_LEFT", "build_lut", "build_vflip",
    "deform_grid", "integrate_svf", "make_affine_matrix", "random_affine",
    "random_nonlinear_field", "Draws", "SubjectBank", "build_knobs_stack",
    "knobs_from_cfg", "synth_item", "build_contrast_lut",
    "sample_contrast_lut", "synth_intensities", "SynthStatic",
    "resolution_sampler", "sample_setup", "augment_pathology",
    "encode_pathology", "random_shape",
]
