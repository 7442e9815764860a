"""Data pipelines: SalData (CSNet), the device front-end, the resident
train/val/TESTALL paths."""

from .pipeline import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    Augment,
    SalData,
    batches,
    device_prefetch,
    preprocess_test_image,
    resize_bilinear_np,
)
from .resident import (
    build_resident_dataset,
    build_resident_val_dataset,
    make_resident_epoch_fn,
    make_resident_val_fn,
)

__all__ = [
    "IMAGENET_MEAN", "IMAGENET_STD", "Augment", "SalData", "batches",
    "device_prefetch", "preprocess_test_image", "resize_bilinear_np",
    "build_resident_dataset", "build_resident_val_dataset",
    "make_resident_epoch_fn", "make_resident_val_fn",
]
