"""Host-side datasets for detection inference and training."""

from .datasets import ImageFolder, ListDataset  # noqa: F401
