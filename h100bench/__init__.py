"""The benchmark of the PyTorch / CUDA port (``styletransfer_tpu_torch``) on
one NVIDIA H100: ``python -m h100bench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once and prints one JSON line.
See ``README.md``."""
