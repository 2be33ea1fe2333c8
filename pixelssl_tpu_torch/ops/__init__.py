from .blur import gaussian_blur_fused
