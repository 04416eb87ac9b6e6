"""Entry point: ``python -m styletransfer_tpu_torch <group> <task>``."""

from styletransfer_tpu_torch.clis import cli

if __name__ == "__main__":
    cli(prog_name="styletransfer_tpu_torch")
