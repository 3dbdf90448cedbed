from mri_superresolution_torch.losses.combined import (  # noqa: F401
    CombinedLoss, compose_loss, l1_loss)
