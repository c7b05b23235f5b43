"""Datasets and loaders. Port of ``keymorph_tpu/data/datasets.py``.

A *subject* is a lazy record (paths and modality); ``load()`` runs the
preprocessing pipeline and returns numpy arrays. Loaders are plain Python
iterables yielding batched numpy dicts (subjects stacked along axis 0) for
the device transfer (:func:`keymorph_tpu_torch.data.loader.device_prefetch`).
The subject lists, pair orders and shuffles are keymorph_tpu's.
"""

from __future__ import annotations

import csv
import dataclasses
import itertools
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from keymorph_tpu_torch.data.preprocess import Preprocessor
from keymorph_tpu_torch.utils import parse_test_mod


@dataclasses.dataclass
class Subject:
    """Lazy pointer to one subject's files (img [+seg, +mask])."""

    img_path: str
    seg_path: Optional[str] = None
    mask_path: Optional[str] = None
    modality: str = ""
    name: str = ""

    def load(self, transform: Optional[Preprocessor] = None) -> Dict[str, np.ndarray]:
        transform = transform or Preprocessor()
        out = transform.load(self.img_path, self.seg_path, self.mask_path)
        out["modality"] = self.modality
        out["name"] = self.name or os.path.basename(self.img_path).split(".")[0]
        return out


class PairedDataset:
    """Pairs of subjects, loaded+transformed on access
    (reference dataset/utils.py:8-31)."""

    def __init__(self, subject_pairs_list, transform: Optional[Preprocessor] = None):
        self.subject_list = list(subject_pairs_list)
        self.transform = transform

    def __len__(self):
        return len(self.subject_list)

    def __getitem__(self, i):
        sub1, sub2 = self.subject_list[i]
        return sub1.load(self.transform), sub2.load(self.transform)


class SingleDataset:
    def __init__(self, subjects, transform: Optional[Preprocessor] = None):
        self.subjects = list(subjects)
        self.transform = transform

    def __len__(self):
        return len(self.subjects)

    def __getitem__(self, i):
        return self.subjects[i].load(self.transform)


class RandomAggregatedDataset:
    """Aggregate datasets, sampling a random member per access
    (reference dataset/utils.py:60-71)."""

    def __init__(self, datasets, seed: int = 0):
        self.datasets = list(datasets)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, i):
        chosen = self.datasets[self._rng.integers(0, len(self.datasets))]
        return chosen[i % len(chosen)]


class SimpleDatasetIterator:
    """Index-order iterator (reference dataset/utils.py:34-57)."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.index = 0

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        self.index = 0
        return self

    def __next__(self):
        if self.index < len(self.dataset):
            item = self.dataset[self.index]
            self.index += 1
            return item
        raise StopIteration


def _stack_batch(items: Sequence[dict]) -> dict:
    """Stack a list of subject dicts into one batched dict."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals, axis=0)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Minimal shuffling/batching loader over an indexable dataset.

    Single-process; background decoding and the device transfer are
    :mod:`keymorph_tpu_torch.data.loader`'s.
    """

    def __init__(self, dataset, batch_size=1, shuffle=False, seed=0, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            items = [self.dataset[int(i)] for i in idx]
            if isinstance(items[0], tuple):  # paired
                yield tuple(
                    _stack_batch([it[k] for it in items]) for k in range(len(items[0]))
                )
            else:
                yield _stack_batch(items)


class KeyMorphDataset:
    """Loader factory: pretrain / train / test loaders
    (reference dataset/utils.py:74-186)."""

    seg_available: bool = False

    def get_subjects(self, train: bool):
        raise NotImplementedError

    def get_pretrain_loader(self, batch_size, num_workers, transform):
        subjects = self.get_subjects(train=True)
        if isinstance(subjects, dict):
            flat = [s for lst in subjects.values() for s in lst]
        else:
            flat = list(subjects[0]) + list(subjects[1])
        return DataLoader(
            SingleDataset(flat, transform), batch_size=batch_size, shuffle=True
        )

    def get_train_loader(self, batch_size, num_workers, mix_modalities, transform):
        subjects = self.get_subjects(train=True)
        if isinstance(subjects, dict):
            mods = list(subjects.keys())
            if mix_modalities:
                mod_pairs = list(itertools.combinations(mods, 2))
            else:
                mod_pairs = [(m, m) for m in mods]
            pairs = []
            for mod1, mod2 in mod_pairs:
                pairs.extend(itertools.product(subjects[mod1], subjects[mod2]))
        else:
            pairs = list(zip(subjects[0], subjects[1]))
        return DataLoader(
            PairedDataset(pairs, transform), batch_size=batch_size, shuffle=True
        )

    def get_test_loaders(self, batch_size, num_workers, transform, list_of_mods):
        subjects = self.get_subjects(train=False)
        if isinstance(subjects, dict):
            pairs = []
            for mod in list_of_mods:
                mod1, mod2 = parse_test_mod(mod)
                if mod1 not in subjects or mod2 not in subjects:
                    continue  # dataset doesn't carry this modality
                pairs.extend(zip(subjects[mod1], subjects[mod2]))
        else:
            pairs = list(zip(subjects[0], subjects[1]))
        return DataLoader(PairedDataset(pairs, transform), batch_size=batch_size)

    def get_loaders(
        self, batch_size, num_workers, mix_modalities, transform, list_of_test_mods
    ):
        return (
            self.get_pretrain_loader(batch_size, num_workers, transform),
            self.get_train_loader(batch_size, num_workers, mix_modalities, transform),
            self.get_test_loaders(batch_size, num_workers, transform, list_of_test_mods),
        )


class CSVDataset(KeyMorphDataset):
    """CSV-described dataset with the reference's two schemas
    (dataset/csv_dataset.py:9-116):

    1. modality schema: columns img_path, seg_path, mask_path, modality, train
       -> dict of subjects keyed by modality
    2. explicit-pairs schema: fixed_*/moving_* columns
       -> (fixed_subjects, moving_subjects) lists
    """

    def __init__(self, csv_file: str):
        self.csv_file = csv_file
        self.seg_available = False

    def _has_modality_header(self):
        with open(self.csv_file) as fh:
            headers = next(csv.reader(fh))
        return "modality" in headers

    def get_subjects(self, train: bool):
        if self._has_modality_header():
            return self._get_subjects_dict(train)
        return self._get_subjects_two_lists(train)

    @staticmethod
    def _opt(path):
        return None if path in (None, "", "None") else path

    def _get_subjects_dict(self, train):
        subjects_dict: Dict[str, List[Subject]] = {}
        with open(self.csv_file, newline="") as fh:
            for row in csv.DictReader(fh):
                if (row["train"].lower() == "true") != train:
                    continue
                modality = row["modality"]
                seg = self._opt(row.get("seg_path"))
                if seg:
                    self.seg_available = True
                subjects_dict.setdefault(modality, []).append(
                    Subject(
                        img_path=row["img_path"],
                        seg_path=seg,
                        mask_path=self._opt(row.get("mask_path")),
                        modality=modality,
                    )
                )
        return subjects_dict

    def _get_subjects_two_lists(self, train):
        fixed, moving = [], []
        with open(self.csv_file, newline="") as fh:
            for row in csv.DictReader(fh):
                if (row["train"].lower() == "true") != train:
                    continue
                for prefix, lst, mod in (
                    ("fixed", fixed, "fixed"),
                    ("moving", moving, "moving"),
                ):
                    seg = self._opt(row.get(f"{prefix}_seg_path"))
                    if seg:
                        self.seg_available = True
                    lst.append(
                        Subject(
                            img_path=row[f"{prefix}_img_path"],
                            seg_path=seg,
                            mask_path=self._opt(row.get(f"{prefix}_mask_path")),
                            modality=mod,
                        )
                    )
        return fixed, moving


class IXIDataset(KeyMorphDataset):
    """IXI directory layout: {root}/{T1,T2,PD} + _mask/_seg siblings;
    subjects [0:428] train, [428:528] test (dataset/ixi_dataset.py:11-111)."""

    TRAIN_SLICE = (0, 428)
    TEST_SLICE = (428, 528)

    def __init__(self, data_root: str, modalities=("T1", "T2", "PD")):
        self.data_root = data_root
        self.modalities = list(modalities)
        self.seg_available = True

    def get_subjects(self, train: bool):
        start, end = self.TRAIN_SLICE if train else self.TEST_SLICE
        subject_dict = {}
        for modality in self.modalities:
            img_dir = Path(self.data_root) / modality
            mask_dir = Path(self.data_root) / f"{modality}_mask"
            seg_dir = Path(self.data_root) / f"{modality}_seg"
            names = sorted(os.listdir(img_dir)) if img_dir.is_dir() else []
            loaded = []
            for fname in names:
                name = fname.split(".")[0]
                mask_path = mask_dir / f"{name}_mask.nii.gz"
                seg_path = seg_dir / f"{name}_seg.nii.gz"
                loaded.append(
                    Subject(
                        img_path=str(img_dir / fname),
                        seg_path=str(seg_path) if seg_path.exists() else None,
                        mask_path=str(mask_path) if mask_path.exists() else None,
                        modality=modality,
                        name=name,
                    )
                )
            subject_dict[modality] = loaded[start:end]
        return subject_dict
