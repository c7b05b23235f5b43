"""The data layer: NIfTI IO, preprocessing, datasets and loaders (host
numpy), and the prefetch to the card. Port of ``keymorph_tpu/data``, with
its exports."""

from keymorph_tpu_torch.data.nifti import NiftiImage, load_nifti, save_nifti  # noqa: F401
from keymorph_tpu_torch.data.preprocess import Preprocessor  # noqa: F401
from keymorph_tpu_torch.data.datasets import (  # noqa: F401
    CSVDataset,
    IXIDataset,
    PairedDataset,
    SimpleDatasetIterator,
)
from keymorph_tpu_torch.data.loader import ThreadPrefetcher, device_prefetch  # noqa: F401
