from unetdc_tpu_torch.losses.losses import (  # noqa: F401
    combined_loss,
    combined_loss_from_logits,
    dice_coef,
    dice_loss,
    focal_dice_loss,
    focal_dice_loss_from_logits,
    focal_loss,
    focal_loss_from_logits,
)
from unetdc_tpu_torch.losses.metrics import (  # noqa: F401
    calculate_metrics,
    confusion_counts,
    pixel_metrics,
    plot_binary_confusion_matrix_with_metrics,
)
