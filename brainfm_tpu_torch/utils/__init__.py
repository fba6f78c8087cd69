from .logging import MetricLogger, SmoothedValue, setup_logging
from .nifti import MRIread, MRIwrite, load_nifti, save_nifti, viewVolume
from .orientation import align_volume_to_ref, get_ras_axes, ras_reorientation

__all__ = ["MRIread", "MRIwrite", "load_nifti", "save_nifti", "viewVolume",
           "align_volume_to_ref", "get_ras_axes", "ras_reorientation",
           "MetricLogger", "SmoothedValue", "setup_logging"]
