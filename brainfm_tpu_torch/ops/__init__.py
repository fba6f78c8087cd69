from .blur import gaussian_blur_3d, gaussian_kernel_1d
from .interp import nearest3d, trilinear3d
from .lut import lut_apply, lut_apply_plain
from .separable import (apply_axis_matrix, gaussian_matrix,
                        linear_resample_matrix, separable_blur_matmul,
                        separable_resample)
from .warp import warp_labels, warp_volume

__all__ = [
    "gaussian_blur_3d", "gaussian_kernel_1d", "nearest3d",
    "trilinear3d", "lut_apply", "lut_apply_plain", "apply_axis_matrix",
    "gaussian_matrix", "linear_resample_matrix", "separable_blur_matmul",
    "separable_resample", "warp_labels", "warp_volume",
]
