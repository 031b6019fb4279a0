from unetdc_tpu_torch.models.unet import (  # noqa: F401
    UNet, UNetDC, fold_batchnorm)
