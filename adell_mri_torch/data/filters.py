"""
Dataset-dictionary filtering.

The port's own copy of ``adell_mri_tpu/data/filters.py`` (host-side, no
framework): the filter mini-language compiled into one predicate, the
``filter_dictionary_with_*`` family and the two fills. The same filters on
the same dictionary keep the same entries in the same order.

Filter string grammar (same as the reference CLI surface):
    "key=value"        field equals value (or value in field if field is a list)
    "key!=value"       field differs from value
    "key>value"        float(field) >  float(value)
    "key<value"        float(field) <  float(value)
    "key(in)a,b,c"     str(field) in {a, b, c}
    "key(match)sub"    sub in str(field)
    "key(!match)sub"   sub not in str(field)

Fill grammar:
    fill_missing_with_value: "key:value"
    fill_conditional:        "key_to_fill:value^key_to_check:value_to_check"
"""

import ast
import logging
import os
from typing import Any, Callable, Dict, List, Sequence

logger = logging.getLogger(__name__)

DatasetDict = Dict[str, Dict[str, Any]]

Predicate = Callable[[Dict[str, Any]], bool]

# ordered: multi-char operators must be tried before their single-char prefixes
_OPS: Sequence[str] = ("!=", "(in)", "(match)", "(!match)", "=", ">", "<")


def _compile_one(f: str) -> Predicate:
    """Compiles a single filter string into a predicate over one entry."""
    for op in _OPS:
        if op in f:
            key, value = f.split(op, 1)
            break
    else:
        raise NotImplementedError(
            f"filter {f!r} must contain one of {list(_OPS)} "
            "(e.g. 'age>50' or 'variable!=true')"
        )

    def eq(entry):
        # list-valued fields (or JSON/py-stringified lists) match on
        # membership, parsed so that values holding '[' (file paths)
        # compare whole; everything else on string equality
        field = entry[key]
        if isinstance(field, str) and field.lstrip().startswith("["):
            try:
                field = ast.literal_eval(field)
            except (ValueError, SyntaxError):
                pass
        if isinstance(field, (list, tuple)):
            return value in [str(x) for x in field]
        return str(field) == value

    table: Dict[str, Predicate] = {
        "=": eq,
        "!=": lambda entry: str(entry[key]) != value,
        ">": lambda entry: float(entry[key]) > float(value),
        "<": lambda entry: float(entry[key]) < float(value),
        "(in)": lambda entry: str(entry[key]) in value.split(","),
        "(match)": lambda entry: value in str(entry[key]),
        "(!match)": lambda entry: value not in str(entry[key]),
    }
    test = table[op]

    def predicate(entry: Dict[str, Any], _key=key, _test=test) -> bool:
        if _key not in entry:
            # absent keys fail unless the caller marked filters optional,
            # handled by the wrapper below via the `optional` closure
            raise KeyError(_key)
        return _test(entry)

    return predicate


def compile_filters(
    filters: List[str], filter_is_optional: bool = False
) -> Predicate:
    """
    Compiles a list of filter strings into one AND-ed predicate.

    Args:
        filters: filter strings (grammar in module docstring).
        filter_is_optional: when True, entries missing a filtered key pass
            that filter instead of failing it.
    """
    compiled = [_compile_one(f) for f in filters]

    def predicate(entry: Dict[str, Any]) -> bool:
        for p in compiled:
            try:
                if not p(entry):
                    return False
            except KeyError:
                if not filter_is_optional:
                    return False
        return True

    return predicate


def filter_dictionary_with_presence(
    D: DatasetDict, filters: List[str]
) -> DatasetDict:
    """Keeps entries containing every key in ``filters``."""
    logger.info("Filtering on presence of %s (input size %d)", filters, len(D))
    out = {
        pid: entry
        for pid, entry in D.items()
        if all(k in entry for k in filters)
    }
    logger.info("Output size: %d", len(out))
    return out


def filter_dictionary_with_existence(
    D: DatasetDict, filters: List[str]
) -> DatasetDict:
    """Keeps entries whose values under ``filters`` are paths that exist."""
    logger.info("Filtering on existence of %s (input size %d)", filters, len(D))
    out = {
        pid: entry
        for pid, entry in D.items()
        if all(k in entry and os.path.exists(str(entry[k])) for k in filters)
    }
    logger.info("Output size: %d", len(out))
    return out


def filter_dictionary_with_possible_labels(
    D: DatasetDict, possible_labels: List[str], label_key: str
) -> DatasetDict:
    """Keeps entries whose ``label_key`` value is one of ``possible_labels``."""
    logger.info("Filtering on labels %s (input size %d)", possible_labels, len(D))
    allowed = {str(x) for x in possible_labels}
    out = {
        pid: entry
        for pid, entry in D.items()
        if label_key in entry and str(entry[label_key]) in allowed
    }
    logger.info("Output size: %d", len(out))
    return out


def filter_dictionary_with_filters(
    D: DatasetDict, filters: List[str], filter_is_optional: bool = False
) -> DatasetDict:
    """Keeps entries passing every compiled filter string."""
    logger.info("Filtering on %s (input size %d)", filters, len(D))
    pred = compile_filters(filters, filter_is_optional)
    out = {pid: entry for pid, entry in D.items() if pred(entry)}
    logger.info("Output size: %d", len(out))
    return out


def filter_dictionary(
    D: DatasetDict,
    filters_presence: List[str] = None,
    filters_existence: List[str] = None,
    possible_labels: List[str] = None,
    label_key: str = None,
    filters: List[str] = None,
    filter_is_optional: bool = False,
) -> DatasetDict:
    """Presence, existence, possible labels, then the filter strings."""
    D = dict(D)
    if filters_presence is not None:
        D = filter_dictionary_with_presence(D, filters_presence)
    if filters_existence is not None:
        D = filter_dictionary_with_existence(D, filters_existence)
    if possible_labels is not None and label_key is not None:
        D = filter_dictionary_with_possible_labels(D, possible_labels, label_key)
    if filters is not None:
        D = filter_dictionary_with_filters(D, filters, filter_is_optional)
    return D


def fill_missing_with_value(D: DatasetDict, filters: List[str]) -> DatasetDict:
    """Imputes absent keys with values from "key:value" specs."""
    pairs = dict(f.split(":", 1) for f in filters)
    n = 0
    for entry in D.values():
        for k, v in pairs.items():
            if k not in entry:
                entry[k] = v
                n += 1
    logger.info("Filled %d missing values", n)
    return D


def fill_conditional(D: DatasetDict, filters: List[str]) -> DatasetDict:
    """
    Imputes "fill_key:fill_value" when "check_key:check_value" matches;
    spec format: "fill_key:fill_value^check_key:check_value".
    """
    specs = []
    for f in filters:
        fill, check = f.split("^", 1)
        specs.append((fill.split(":", 1), check.split(":", 1)))
    n = 0
    for entry in D.values():
        for (fill_key, fill_value), (check_key, check_value) in specs:
            if (
                check_key in entry
                and str(entry[check_key]) == str(check_value)
                and fill_key not in entry
            ):
                entry[fill_key] = fill_value
                n += 1
    logger.info("Conditionally filled %d values", n)
    return D
