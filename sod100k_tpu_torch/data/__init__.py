"""Data pipelines: SalData (CSNet), the .lst datasets (CSF), the device
front-end, the resident train/val/TESTALL paths."""

from .csf_dataset import (CSFJointTrainData, CSFTestData, CSFTrainData,
                          fixed_size_batches, padded_batches)
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
    make_resident_csf_epoch_fn,
    make_resident_epoch_fn,
    make_resident_val_fn,
)

__all__ = [
    "IMAGENET_MEAN", "IMAGENET_STD", "Augment", "SalData", "batches",
    "device_prefetch", "preprocess_test_image", "resize_bilinear_np",
    "build_resident_dataset", "build_resident_val_dataset",
    "make_resident_csf_epoch_fn", "make_resident_epoch_fn",
    "make_resident_val_fn", "CSFTrainData", "CSFTestData",
    "CSFJointTrainData", "padded_batches", "fixed_size_batches",
]
