"""
Dataset-JSON layer.

The port's own copy of ``adell_mri_tpu/data/dataset.py`` (host-side,
numpy): a dataset file maps ``{id: {key: path-or-value}}``; ``Dataset``
loads and merges such files, fills and filters entries
(``data/filters.py``), drops excluded IDs, subsamples with its seeded
``rng`` and gives datalists. ``parse_ids`` reads ID lists and folds. With
the same seed the same calls keep the same IDs in the same order as the
JAX package's.
"""

import json
import logging
import os
from copy import deepcopy
from typing import Any, Dict, Iterator, List, Union

import numpy as np

from adell_mri_torch.data.filters import (
    DatasetDict,
    fill_conditional,
    fill_missing_with_value,
    filter_dictionary,
)

logger = logging.getLogger(__name__)


def _load_structured(path: str):
    with open(path) as f:
        if str(path).endswith((".yaml", ".yml")):
            import yaml

            return yaml.safe_load(f)
        return json.load(f)


def parse_ids(id_list: Union[List[str], str, None],
              output_format: str = "nested_list"):
    """ID specifications: each element is a path to a JSON/YAML (a list or
    the keys of a mapping) or CSV/text file of IDs, a comma-separated
    string of IDs or one ID. ``output_format`` "list" flattens them,
    "nested_list" keeps one list per element (folds)."""

    def parse_one(x) -> List[str]:
        if isinstance(x, (list, tuple)):
            return [str(i) for i in x]
        x = str(x)
        if os.path.isfile(x):
            if x.endswith((".json", ".yaml", ".yml")):
                data = _load_structured(x)
                return [str(i) for i in (data if isinstance(data, list)
                                         else data.keys())]
            with open(x) as f:
                return [token for line in f
                        for token in line.strip().split(",") if token]
        return [i for i in x.split(",") if i]

    if id_list is None:
        return []
    if isinstance(id_list, str):
        id_list = [id_list]
    nested = [parse_one(x) for x in id_list]
    if output_format == "list":
        return [i for sub in nested for i in sub]
    return nested


def subsample_dataset(data_dict: DatasetDict, subsample_size: int,
                      rng: np.random.Generator,
                      strata_key: str = None) -> DatasetDict:
    """``subsample_size`` entries drawn with ``rng``; with ``strata_key``
    each stratum keeps its share, the seats that flooring leaves going to
    the largest remainders (so a small stratum keeps its seat)."""
    if subsample_size is None or len(data_dict) <= subsample_size:
        return data_dict
    if strata_key is not None:
        strata: Dict[Any, List[str]] = {}
        for k, entry in data_dict.items():
            strata.setdefault(entry[strata_key], []).append(k)
        quotas = {
            s: len(keys) / len(data_dict) * subsample_size
            for s, keys in strata.items()
        }
        counts = {s: int(q) for s, q in quotas.items()}
        short = subsample_size - sum(counts.values())
        for s in sorted(quotas, key=lambda s: quotas[s] - counts[s],
                        reverse=True)[:short]:
            counts[s] += 1
        keep = []
        for s, keys in strata.items():
            n = min(counts[s], len(keys))
            keep.extend(rng.choice(keys, size=n, replace=False,
                                   shuffle=False))
    else:
        keep = rng.choice(list(data_dict), size=subsample_size,
                          replace=False)
    return {k: data_dict[k] for k in keep}


class Dataset:
    """Loads and merges dataset files; fills, filters and subsamples them
    (``rng``, by default seeded with ``seed``)."""

    def __init__(self, path: Union[str, List[str], None],
                 rng: np.random.Generator = None, seed: int = 42,
                 dataset_name: str = "dataset"):
        self.dataset: DatasetDict = {}
        self.dataset_name = dataset_name
        self.load_dataset(path)
        self.dataset_original = deepcopy(self.dataset)
        self.rng = np.random.default_rng(seed) if rng is None else rng

    def load_dataset(self, path: Union[str, List[str], None]):
        if path is None:
            return
        if isinstance(path, (list, tuple)):
            for p in path:
                self.load_dataset(p)
            return
        self.dataset.update(_load_structured(path))

    def fill_conditional(self, filters: List[str] = None):
        if filters is not None:
            self.dataset = fill_conditional(self.dataset, filters)

    def fill_missing_with_value(self, filters: List[str] = None):
        if filters is not None:
            self.dataset = fill_missing_with_value(self.dataset, filters)

    def filter_dictionary(
        self,
        filters_presence: List[str] = None,
        filters_existence: List[str] = None,
        possible_labels: List[str] = None,
        label_key: str = None,
        filters: List[str] = None,
        filter_is_optional: bool = False,
        fill_conditional: List[str] = None,
        fill_missing_with_value: List[str] = None,
    ):
        self.fill_conditional(fill_conditional)
        self.fill_missing_with_value(fill_missing_with_value)
        self.dataset = filter_dictionary(
            self.dataset,
            filters_presence=filters_presence,
            filters_existence=filters_existence,
            possible_labels=possible_labels,
            label_key=label_key,
            filters=filters,
            filter_is_optional=filter_is_optional,
        )

    def subsample_dataset(self, subsample_size: int = None,
                          strata_key: str = None,
                          key_list: Union[List[str], str] = None,
                          excluded_key_list: Union[List[str], str] = None):
        """Keeps ``key_list``, else drops ``excluded_key_list``, else draws
        ``subsample_size`` entries."""
        n_start = len(self.dataset)
        if key_list is not None:
            keep = set(parse_ids(key_list, "list"))
            self.dataset = {k: v for k, v in self.dataset.items()
                            if k in keep}
        elif excluded_key_list is not None:
            drop = set(parse_ids(excluded_key_list, "list"))
            self.dataset = {k: v for k, v in self.dataset.items()
                            if k not in drop}
        elif subsample_size is not None:
            self.dataset = subsample_dataset(self.dataset, subsample_size,
                                             self.rng, strata_key)
        logger.info("%s: %d -> %d samples", self.dataset_name, n_start,
                    len(self))

    def apply_filters(self, **filter_dict: Any):
        """The whole filter battery, keys as the JAX package's:
        fill_conditional, fill_missing_with_placeholder, possible_labels,
        label_keys, presence_keys, filters_existence, filter_on_keys,
        filter_is_optional, excluded_ids, subsample_size."""
        if "fill_conditional" in filter_dict:
            self.fill_conditional(filter_dict["fill_conditional"])
        if "fill_missing_with_placeholder" in filter_dict:
            self.fill_missing_with_value(
                filter_dict["fill_missing_with_placeholder"])
        self.filter_dictionary(
            possible_labels=filter_dict.get("possible_labels"),
            label_key=filter_dict.get("label_keys"),
            filters_presence=filter_dict.get("presence_keys"),
            filters_existence=filter_dict.get("filters_existence"),
            filters=filter_dict.get("filter_on_keys"),
            filter_is_optional=filter_dict.get("filter_is_optional", False),
        )
        if "excluded_ids" in filter_dict:
            self.subsample_dataset(
                excluded_key_list=filter_dict["excluded_ids"])
        if "subsample_size" in filter_dict:
            self.subsample_dataset(
                subsample_size=filter_dict["subsample_size"],
                strata_key=filter_dict.get("label_keys"))

    def to_datalist(self, key_list: List[str] = None) -> List[Dict]:
        """``[{**entry, "identifier": id}, ...]`` in the dataset's order."""
        if key_list is None:
            keys = list(self.dataset)
        else:
            wanted = set(parse_ids(key_list, "list"))
            keys = [k for k in self.dataset if k in wanted]
        return [{**self.dataset[k], "identifier": k} for k in keys]

    def keys(self):
        return self.dataset.keys()

    def __getitem__(self, key) -> Any:
        if isinstance(key, (list, tuple)):
            return {k: self.dataset[k] for k in key}
        return self.dataset[key]

    def __setitem__(self, key: str, value: Any):
        self.dataset[key] = value

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator[str]:
        yield from self.dataset
