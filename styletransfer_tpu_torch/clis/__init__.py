"""Command-line interface: ``python -m styletransfer_tpu_torch <group> <task>``.

The same contract as the JAX package's CLI for the commands the port has
(``fast_st train``, ``convert-image``, ``convert-dir`` and
``convert-image-multi``; the one-shot
``gatys_st``; ``video_st train``, ``convert-video`` and ``convert-dir``),
plus ``--device``.
"""

import click

from styletransfer_tpu_torch.clis import fast_st, gatys_st, video_st


@click.group(commands={"fast_st": fast_st.fast_st, "gatys_st": gatys_st.gatys_st,
                       "video_st": video_st.video_st})
def cli():
    """Style Transfer (PyTorch / CUDA)"""
