from .blur import gaussian_blur_fused
from .confusion import confusion_matrix, scores_from_confusion
from .boxmask import box_masks
