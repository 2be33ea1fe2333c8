from .gaussian_blur import gaussian_blur, gaussian_kernel_1d
from .gaussian_noise import apply_noise, gaussian_noise
