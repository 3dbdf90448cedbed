from mri_superresolution_torch.data.dataset import (  # noqa: F401
    BatchLoader, PairedSliceDataset, StreamingBatchLoader, subject_split,
    train_val_split)
