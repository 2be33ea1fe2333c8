from .gaussian_blur import gaussian_blur, gaussian_kernel_1d
