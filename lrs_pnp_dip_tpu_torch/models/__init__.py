from .common import BatchNorm2d, Conv2d, activation, concat_center_crop, pad_input, upsample2x
from .skip import Skip, dip_skip_128
from .transplant import skip_params_from_flax

__all__ = [
    "BatchNorm2d",
    "Conv2d",
    "Skip",
    "activation",
    "concat_center_crop",
    "dip_skip_128",
    "pad_input",
    "skip_params_from_flax",
    "upsample2x",
]
