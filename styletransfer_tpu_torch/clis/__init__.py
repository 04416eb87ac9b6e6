"""Command-line interface: ``python -m styletransfer_tpu_torch <group> <task>``.

The same contract as the JAX package's CLI for the commands the port has
(``fast_st train``, ``train-multi``, ``pack-dataset``, ``convert-image``, ``convert-dir``,
``convert-image-multi``, ``serve`` and ``serve-multi``; ``gatys_st``, one-shot
or ``--serve``; ``video_st train``, ``convert-video``, ``convert-dir`` and
``serve``; the daemons also over ``--tcp`` / ``--http``; ``doctor``), plus
``--device``.
"""

import click

from styletransfer_tpu_torch.clis import doctor, fast_st, gatys_st, video_st


@click.group(commands={"fast_st": fast_st.fast_st, "gatys_st": gatys_st.gatys_st,
                       "video_st": video_st.video_st, "doctor": doctor.doctor})
def cli():
    """Style Transfer (PyTorch / CUDA)"""
