from .build import (Joiner, SepJoiner, TwoStage, apply_processors,
                    build_backbone, build_conditioned_model,
                    build_critic_from_cfg, build_inpaint_model, build_model,
                    build_pathol_critic, implicit_pathol_outputs, postprocess,
                    process_args, process_outputs, twostage_forward)
from .criterion import make_criterion
from .heads import ConvBlock, DepHead, TaskHead
from .losses import (gaussian_loss, gradient_loss, hessian_loss, l1_loss,
                     l2_loss, laplace_loss, smoothness_loss)
from .params_io import from_jax_params, load_pth
from .unet3d import UNet2D, UNet3D, UNet3DSep, feature_maps

__all__ = ["Joiner", "SepJoiner", "TwoStage", "apply_processors",
           "build_backbone", "build_conditioned_model",
           "build_critic_from_cfg", "build_inpaint_model", "build_model",
           "build_pathol_critic", "implicit_pathol_outputs", "postprocess",
           "process_args", "process_outputs", "twostage_forward",
           "ConvBlock", "DepHead", "TaskHead", "from_jax_params", "load_pth",
           "UNet2D", "UNet3D", "UNet3DSep", "feature_maps",
           "make_criterion", "gaussian_loss", "gradient_loss",
           "hessian_loss", "l1_loss", "l2_loss", "laplace_loss",
           "smoothness_loss"]
