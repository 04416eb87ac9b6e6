"""Shared CLI option parsing: the port's copy of
``styletransfer_tpu/clis/common.py``."""

from typing import List, Optional

import click


def parse_sizes_option(sizes: Optional[str]) -> Optional[List[int]]:
    """``--sizes "S1,S2,..."`` -> int list (or None when unset).

    One parser for the bucketed serve commands (``fast_st serve``,
    ``serve-multi``); the engine-side validation lives in
    ``engines.daemon.normalize_buckets``.
    """
    if not sizes:
        return None
    try:
        out = [int(s) for s in sizes.split(",") if s.strip()]
    except ValueError:
        raise click.UsageError(
            f"--sizes must be a comma list of ints, got {sizes!r}"
        )
    if not out:
        raise click.UsageError("--sizes is empty")
    return out
