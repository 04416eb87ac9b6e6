"""The arrays of the ``.orbax`` fixture ``tests/torch_fixtures/seeded.orbax``,
made from a seed with numpy alone. ``scripts/torch_make_orbax_fixture.py``
saves them with the JAX package; ``chip_smoke.py`` and the tests rebuild
them here to check what the port decodes, with no JAX in their process."""

import numpy as np

SEED = 18


def fixture_arrays(seed: int = SEED):
    """The fixture's tree: one chunk over 128 KiB (two zstd blocks), a
    periodic one (zstd matches and repeat offsets), small ones (inline
    OCDBT values), a 0-D one, and three levels of keys."""
    rng = np.random.default_rng(seed)
    return {
        "conv1": {"kernel": rng.standard_normal((9, 9, 3, 32)).astype(np.float32),
                  "bias": rng.standard_normal(32).astype(np.float32)},
        "res1": {"conv": {"kernel": rng.standard_normal((3, 3, 64, 64)).astype(np.float32)},
                 "in": {"scale": np.tile(np.arange(16, dtype=np.float32) / 8, 8)}},
        "pattern": (np.arange(24_000) % 97).astype(np.float32).reshape(100, 240),
        "step": np.asarray(rng.standard_normal(), np.float32),
    }
