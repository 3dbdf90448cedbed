from mri_superresolution_torch.infer.engine import (  # noqa: F401
    InferenceEngine, load_engine, preprocess_image_array)
