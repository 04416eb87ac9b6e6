#!/usr/bin/env python3
"""Write the ``.orbax`` checkpoint fixture that the port's Orbax reader is
held against: a few float32 arrays made from a seed with numpy, saved by the
JAX package's ``ckpt.save`` (orbax and tensorstore: zstd-compressed zarr
chunks in an OCDBT database with a per-process sub-database).

    python scripts/torch_make_orbax_fixture.py [OUT]

OUT defaults to ``tests/torch_fixtures/seeded.orbax``. The arrays come from
``scripts/torch_orbax_fixture_arrays.py``, which needs numpy alone, so
``chip_smoke.py`` rebuilds them from the seed to check what the port
decodes; only writing the fixture needs JAX.
"""

from __future__ import annotations

import os
import shutil
import sys

from torch_orbax_fixture_arrays import fixture_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "torch_fixtures", "seeded.orbax")


def main(out: str = DEFAULT_OUT) -> None:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from styletransfer_tpu import ckpt

    shutil.rmtree(out, ignore_errors=True)
    ckpt.save(fixture_arrays(), out)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    print(f"wrote {out}: {size} bytes")


if __name__ == "__main__":
    main(*sys.argv[1:])
