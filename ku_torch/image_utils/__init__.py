"""Image utilities (port of ``ku.image_utils``), and a stdlib PNG writer
and reader."""

from ku_torch.image_utils.utility import (
    DEVICE_CPU,
    DEVICE_GPU,
    resize,
    resize_image_to_target_symmeric_size,
    get_one_hot,
    resize_batch,
)
from ku_torch.image_utils.png import read_png, write_png
