"""Entry point: ``python -m styletransfer_tpu_torch <group> <task>``, with the
colored-traceback hook when that optional package is installed."""

try:
    import colored_traceback

    colored_traceback.add_hook()
except ImportError:
    pass

from styletransfer_tpu_torch.clis import cli  # noqa: E402

if __name__ == "__main__":
    cli(prog_name="styletransfer_tpu_torch")
