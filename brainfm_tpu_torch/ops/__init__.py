from .blur import gaussian_blur_3d, gaussian_kernel_1d
from .bounds import BOUND_CODES, apply_bound
from .coeff import spline_coeff, spline_coeff_nd
from .fd import curl_3d, gradient_b, gradient_c, gradient_f
from .interp import interp3d, nearest3d, trilinear3d
from .lut import lut_apply, lut_apply_plain
from .ode import odeint, odeint_adjoint, odeint_masked_final
from .pde import advect_rhs, apply_neumann_bc
from .perlin import fractal_noise_3d, perlin_noise_3d, shape_3d, velocity_3d
from .pushpull import (add_identity_grid, affine_grid, grid_count, grid_grad,
                       grid_hess, grid_pull, grid_push, identity_grid)
from .resize import (myzoom, myzoom_anisotropic, resize_spline,
                     restrict_spline, volume_resize)
from .separable import (apply_axis_matrix, gaussian_matrix,
                        linear_resample_matrix, separable_blur_matmul,
                        separable_resample)
from .splines import spline_grad, spline_hess, spline_weight
from .warp import warp_labels, warp_volume

__all__ = [
    "gaussian_blur_3d", "gaussian_kernel_1d", "BOUND_CODES", "apply_bound",
    "spline_coeff", "spline_coeff_nd", "curl_3d", "gradient_b", "gradient_c",
    "gradient_f", "interp3d", "nearest3d", "trilinear3d", "lut_apply",
    "lut_apply_plain", "odeint", "odeint_adjoint", "odeint_masked_final",
    "advect_rhs", "apply_neumann_bc", "fractal_noise_3d", "perlin_noise_3d",
    "shape_3d", "velocity_3d", "add_identity_grid", "affine_grid",
    "grid_count", "grid_grad", "grid_hess", "grid_pull", "grid_push",
    "identity_grid", "myzoom", "myzoom_anisotropic", "resize_spline",
    "restrict_spline", "volume_resize", "apply_axis_matrix",
    "gaussian_matrix", "linear_resample_matrix", "separable_blur_matmul",
    "separable_resample", "spline_grad", "spline_hess", "spline_weight",
    "warp_labels", "warp_volume",
]
