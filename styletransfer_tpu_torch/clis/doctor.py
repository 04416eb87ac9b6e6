"""``doctor`` CLI: environment diagnostics (``utils/doctor.py``)."""

import sys

import click


@click.command()
@click.option("--backend", default="auto", type=click.Choice(["auto", "cpu", "none"]),
              help="Device probes: auto probes the card AND the CPU path; cpu probes only "
                   "the CPU path (fast); none skips device probes.")
@click.option("--timeout", default=120.0, show_default=True,
              help="Per-probe timeout in seconds. A card that cannot answer within this "
                   "is hung, not slow.")
def doctor(backend, timeout):
    """
    Diagnose the environment: probe the card (in a subprocess, with a
    timeout), and report the state of every degradable dependency (nvcc and
    the kernel build, pretrained VGG19, mp4 codecs, demo assets,
    checkpoints) with the fallback that is active for each.

    Exits non-zero only if something is actually broken ([FAIL]); [WARN]
    rows are documented degraded modes.
    """
    from styletransfer_tpu_torch.utils import doctor as doc

    checks = doc.run_checks(
        backend=backend, timeout=timeout,
        progress=lambda c: print(f"{doc.TAGS[c.status]} {c.name}: {c.detail}", flush=True),
    )
    if any(c.status == "fail" for c in checks):
        sys.exit(1)
