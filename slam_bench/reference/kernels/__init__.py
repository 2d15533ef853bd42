from .cfar_cuda import cfar_detect, cfar_os_plain, cfar_plain
from .cfar_factors import threshold_factor_soca
